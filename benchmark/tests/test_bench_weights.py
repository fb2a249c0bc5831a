"""The benchmark's own weight draw: its trees have the layout the port's
constructors take (every path and shape of the port's own random trees at
tiny sizes), the same seed gives the same weights, and every leaf has the
spread its init asks for."""

import dataclasses
import json
import math

import pytest
import torch

from benchmark import weights

BIG = 2 ** 31 + 99


def _d(cfg):
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def _shapes(tree, path=()):
    if isinstance(tree, torch.Tensor):
        return {path: tuple(tree.shape)}
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        out.update(_shapes(v, (*path, k)))
    return out


def _port_trees():
    from flux_generator_tpu_torch.pipelines.flux import FluxPipeline
    from flux_generator_tpu_torch.pipelines.musicgen import MusicGenPipeline

    g = torch.Generator().manual_seed(0)
    flux = FluxPipeline.random_init("flux-schnell", tiny=True, dtype=torch.float32, device="cpu", generator=g)
    music = MusicGenPipeline.random_init(tiny=True, dtype=torch.float32, device="cpu", generator=g)
    return flux, music


def test_trees_have_the_ports_layout():
    from flux_generator_tpu_torch.models.t5.t5 import init_t5_encoder, tiny_t5_config

    flux, music = _port_trees()
    cfg = {"flow": _d(flux.flow_cfg), "ae": _d(flux.ae_cfg), "clip": _d(flux.clip_cfg), "t5": _d(flux.t5_cfg)}
    assert _shapes(weights.draw(weights.flux(cfg), 1, "cpu", torch.bfloat16)) == _shapes(flux.params)
    for spec, port in ((weights.musicgen_decoder(_d(music.cfg)), music.params),
                       (weights.encodec(_d(music.audio_decoder.cfg)), music.audio_decoder.params)):
        assert _shapes(weights.draw(spec, 1, "cpu", torch.float32)) == _shapes(port)
    for ff in ("gated-gelu", "relu"):
        c = tiny_t5_config(feed_forward_proj=ff)
        assert (_shapes(weights.draw(weights.t5_encoder(_d(c)), 1, "cpu", torch.float32))
                == _shapes(init_t5_encoder(torch.Generator().manual_seed(0), c)))


def test_full_size_counts():
    from benchmark.harness import ROOT

    flux = json.loads((ROOT / "benchmark/configs/flux-schnell.json").read_text())
    music = json.loads((ROOT / "benchmark/configs/musicgen-medium.json").read_text())

    def count(spec):
        return sum(math.prod(leaf.shape) for _, leaf in weights.leaves(spec))

    # FLUX.1's 11,901,408,320 less the guidance embedder that schnell leaves out (256·3072 + 3072 + 3072² + 3072)
    assert count(weights.flux_flow(flux["flow"])) == 11_901_408_320 - 10_229_760
    assert count(weights.musicgen_decoder(music["decoder"])) == pytest.approx(1.84e9, rel=0.01)
    assert count(weights.t5_encoder(music["t5"])) == pytest.approx(109.6e6, rel=0.01)  # T5-base's encoder
    assert weights.encodec_quantizers(music["encodec"]) == 4


def test_same_seed_same_weights_and_spreads():
    flux, _ = _port_trees()
    cfg = {"flow": _d(flux.flow_cfg), "ae": _d(flux.ae_cfg), "clip": _d(flux.clip_cfg), "t5": _d(flux.t5_cfg)}
    spec = weights.flux(cfg)
    a, b = (weights.draw(spec, BIG, "cpu", torch.bfloat16) for _ in range(2))
    c = weights.draw(spec, BIG + 1, "cpu", torch.bfloat16)
    ka, kb, kc = (t["flow"]["double_blocks"]["img_attn"]["qkv"]["kernel"] for t in (a, b, c))
    assert torch.equal(ka, kb) and not torch.equal(ka, kc)
    flat = dict(weights.leaves(spec))
    drawn = {path: t for path, t in _leaves(a)}
    base = min(t.data_ptr() for t in drawn.values())
    for path, leaf in flat.items():
        t = drawn[path].float()
        assert (t - leaf.center).abs().max() <= leaf.bound * (1 + 1e-2) + abs(leaf.center) * 2 ** -7  # bf16
        if t.numel() >= 4096:
            assert t.std().item() == pytest.approx(leaf.bound / math.sqrt(3), rel=0.05)
        assert (drawn[path].data_ptr() - base) % 256 == 0  # each leaf starts 256 bytes aligned in the buffer


def _leaves(tree, path=()):
    if isinstance(tree, torch.Tensor):
        yield path, tree
        return
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        yield from _leaves(v, (*path, k))
