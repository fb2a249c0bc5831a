"""Image-comparison metrics (the port's own copy of
flux_generator_tpu/utils/metrics.py):

  * PSNR and SSIM (Wang et al. 2004, the standard 11×11 Gaussian window), in
    numpy, needing no weights;
  * LPIPS (v0.1, VGG16 backbone and LPIPS linear heads), on the current CUDA
    device unless `device` says otherwise, from two standard files in a
    directory:
        vgg16-397923af.pth   — torchvision VGG16 ImageNet weights
        lpips_vgg.pth        — LPIPS v0.1 linear weights ("vgg" variant,
                               keys lin0..lin4.model.1.weight)
    The architectures are fixed and rebuilt here from the state dicts, so
    neither torchvision nor the lpips package is needed.

All functions take HWC float images in [0, 1] (or [0, 255] uint8).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..runtime.device import as_device

VGG_WEIGHTS_FILE = "vgg16-397923af.pth"
LPIPS_WEIGHTS_FILE = "lpips_vgg.pth"


def _to_float(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float64) / 255.0
    return img.astype(np.float64)


def psnr(a, b, data_range: float = 1.0) -> float:
    a, b = _to_float(a), _to_float(b)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    w = np.outer(g, g)
    return w / w.sum()


def _filter2d(img: np.ndarray, win: np.ndarray) -> np.ndarray:
    """Valid-mode 2-D correlation per channel via stride tricks (no scipy)."""
    k = win.shape[0]
    h, w = img.shape[:2]
    oh, ow = h - k + 1, w - k + 1
    s = img.strides
    view = np.lib.stride_tricks.as_strided(
        img, (oh, ow, k, k, *img.shape[2:]), (s[0], s[1], s[0], s[1], *s[2:]),
        writeable=False,
    )
    return np.einsum("xyijc,ij->xyc", view, win)


def ssim(a, b, data_range: float = 1.0, win_size: int = 11,
         sigma: float = 1.5) -> float:
    """Mean SSIM with the standard Gaussian window, averaged over channels.
    Matches the common skimage/tf settings (K1=0.01, K2=0.03)."""
    a, b = _to_float(a), _to_float(b)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    m = min(a.shape[0], a.shape[1])
    if m < win_size:
        # largest odd window that still FITS: `m | 1` would round an even
        # dim UP past the image (8 -> 9 -> empty correlation -> NaN)
        win_size = max(1, (m - 1) | 1 if m % 2 == 0 else m)
    win = _gaussian_window(win_size, sigma)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2d(a, win)
    mu_b = _filter2d(b, win)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = _filter2d(a * a, win) - mu_aa
    s_bb = _filter2d(b * b, win) - mu_bb
    s_ab = _filter2d(a * b, win) - mu_ab
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return float(np.mean(num / den))


# ------------------------------------------------------------------ LPIPS

# VGG16 feature layout: (out_channels, layers-per-stage); LPIPS taps the
# activations right after the last ReLU of each stage.
_VGG_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
# the "scaling layer" LPIPS applies to [-1, 1] inputs
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def _build_vgg_features(state_dict, device):
    """Reconstruct torchvision VGG16 `features` from its state dict (keys
    features.{i}.weight/bias at conv indices 0,2,5,7,10,...) on `device`."""
    from torch import nn

    layers = []
    idx = 0
    cin = 3
    taps = []
    for cout, reps in _VGG_STAGES:
        for _ in range(reps):
            conv = nn.Conv2d(cin, cout, 3, padding=1)
            conv.weight.data = state_dict[f"features.{idx}.weight"]
            conv.bias.data = state_dict[f"features.{idx}.bias"]
            layers += [conv, nn.ReLU(inplace=False)]
            idx += 2
            cin = cout
        taps.append(len(layers) - 1)  # index of the stage's last ReLU
        layers.append(nn.MaxPool2d(2))
        idx += 1
    seq = nn.Sequential(*layers[: taps[-1] + 1]).eval().to(device)  # drop final pool
    for p in seq.parameters():
        p.requires_grad_(False)
    return seq, taps


class LPIPS:
    """LPIPS(v0.1, vgg) distance from raw weight files, in f32 on `device`
    (the current CUDA device when None).

    weights_dir must contain VGG_WEIGHTS_FILE and LPIPS_WEIGHTS_FILE (see
    module docstring). The lin weights are 1×1 convs over unit-normalized
    VGG features; distance = Σ_stages mean_hw(lin_s(Δfeat²))."""

    def __init__(self, weights_dir, device=None):
        self.device = as_device(device)
        weights_dir = Path(weights_dir)
        vgg_sd = torch.load(weights_dir / VGG_WEIGHTS_FILE,
                            map_location="cpu", weights_only=True)
        self.net, self.taps = _build_vgg_features(vgg_sd, self.device)
        lp = torch.load(weights_dir / LPIPS_WEIGHTS_FILE,
                        map_location="cpu", weights_only=True)
        self.lins = []
        for i in range(5):
            for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
                if key in lp:
                    self.lins.append(lp[key].float().to(self.device))  # (1, C, 1, 1)
                    break
            else:
                raise KeyError(f"LPIPS weights missing lin{i}")

    @staticmethod
    def available(weights_dir) -> bool:
        d = Path(weights_dir)
        return (d / VGG_WEIGHTS_FILE).exists() and (d / LPIPS_WEIGHTS_FILE).exists()

    def _features(self, img):
        x = torch.from_numpy(_to_float(img)[None].transpose(0, 3, 1, 2)).float().to(self.device)
        x = x * 2 - 1  # LPIPS takes [-1, 1]
        shift = torch.tensor(_LPIPS_SHIFT, device=self.device).view(1, 3, 1, 1)
        scale = torch.tensor(_LPIPS_SCALE, device=self.device).view(1, 3, 1, 1)
        x = (x - shift) / scale
        feats = []
        with torch.no_grad():
            for i, layer in enumerate(self.net):
                x = layer(x)
                if i in self.taps:
                    # unit-normalize over channels (LPIPS normalize_tensor)
                    n = torch.sqrt((x**2).sum(dim=1, keepdim=True)) + 1e-10
                    feats.append(x / n)
        return feats

    def distance(self, a, b) -> float:
        fa, fb = self._features(a), self._features(b)
        total = 0.0
        with torch.no_grad():
            for f1, f2, lin in zip(fa, fb, self.lins):
                d = (f1 - f2) ** 2
                w = lin.clamp(min=0)  # LPIPS constrains lins non-negative
                total += float((d * w).sum(dim=1, keepdim=True).mean())
        return total

    __call__ = distance


def compare_images(a, b, lpips_weights_dir=None, device=None) -> dict:
    """One-stop comparison: PSNR + SSIM always, LPIPS (on `device`) when
    weights exist."""
    out = {"psnr_db": psnr(a, b), "ssim": ssim(a, b)}
    if lpips_weights_dir and LPIPS.available(lpips_weights_dir):
        out["lpips"] = LPIPS(lpips_weights_dir, device).distance(a, b)
    return out
