"""The port's image metrics (utils/metrics.py) against the JAX package's on
the same seeded numpy images: PSNR and SSIM within 1e-6 (the same numpy
arithmetic), and LPIPS and compare_images within 1e-6 on random weight files
in the torchvision VGG16 and LPIPS v0.1 formats, with the port on
device="cpu"."""

import numpy as np
import pytest
import torch

from flux_generator_tpu.utils import metrics as jmetrics
from flux_generator_tpu_torch.utils import metrics

TOL = 1e-6


def _img(seed, h=32, w=32):
    return np.random.RandomState(seed).rand(h, w, 3)


PAIRS = {
    "noisy": (_img(0), np.clip(_img(0) + 0.05 * _img(1), 0, 1)),
    "unrelated": (_img(2), _img(3)),
    "uint8": ((_img(4) * 255).astype(np.uint8), (_img(5) * 255).astype(np.uint8)),
    "small": (_img(6, 7, 9), _img(7, 7, 9)),
    "gray": (_img(8)[..., 0], _img(9)[..., 0]),
}


@pytest.mark.parametrize("name", list(PAIRS))
def test_psnr_and_ssim_match_jax(name):
    a, b = PAIRS[name]
    assert metrics.psnr(a, b) == pytest.approx(jmetrics.psnr(a, b), abs=TOL)
    assert metrics.ssim(a, b) == pytest.approx(jmetrics.ssim(a, b), abs=TOL)
    assert metrics.psnr(a, a) == float("inf")
    assert metrics.ssim(a, a) == pytest.approx(1.0, abs=1e-9)


@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    """Random files in the formats the real ones ship in: a torchvision
    vgg16 state dict (features.N.weight OIHW, and classifier.* that must be
    ignored) and LPIPS v0.1 lin heads (linN.model.1.weight, (1, C, 1, 1))."""
    d = tmp_path_factory.mktemp("lpips")
    g = torch.Generator().manual_seed(0)
    vgg, idx, cin = {}, 0, 3
    for cout, reps in [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]:
        for _ in range(reps):
            vgg[f"features.{idx}.weight"] = torch.randn(cout, cin, 3, 3, generator=g) * 0.05
            vgg[f"features.{idx}.bias"] = torch.randn(cout, generator=g) * 0.01
            idx += 2
            cin = cout
        idx += 1  # pool
    vgg["classifier.0.weight"] = torch.zeros(8, 8)
    torch.save(vgg, d / metrics.VGG_WEIGHTS_FILE)
    lins = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=g) - 0.2
            for i, c in enumerate([64, 128, 256, 512, 512])}
    torch.save(lins, d / metrics.LPIPS_WEIGHTS_FILE)
    return d


def test_lpips_matches_jax(lpips_weights):
    lp, jlp = metrics.LPIPS(lpips_weights, device="cpu"), jmetrics.LPIPS(lpips_weights)
    a, b = _img(10, 48, 48), _img(11, 48, 48)
    near = np.clip(a + 0.02 * (b - a), 0, 1)
    for x, y in ((a, b), (a, near), ((a * 255).astype(np.uint8), b)):
        assert lp(x, y) == pytest.approx(jlp(x, y), abs=TOL, rel=TOL)
    assert lp(a, a) == pytest.approx(0.0, abs=1e-9)
    assert lp(a, near) < lp(a, b)


def test_compare_images_matches_jax(lpips_weights, tmp_path):
    a, b = _img(12, 40, 40), _img(13, 40, 40)
    got = metrics.compare_images(a, b, lpips_weights_dir=lpips_weights, device="cpu")
    want = jmetrics.compare_images(a, b, lpips_weights_dir=lpips_weights)
    assert set(got) == set(want) == {"psnr_db", "ssim", "lpips"}
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=TOL, rel=TOL)
    # without weight files: PSNR and SSIM only
    assert set(metrics.compare_images(a, b, lpips_weights_dir=tmp_path, device="cpu")) == {"psnr_db", "ssim"}
