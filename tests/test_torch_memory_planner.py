"""The port's memory planner (server/memory.py) on the CPU, mirroring
tests/test_memory_planner.py with explicit budgets. The port's footprints
are its own (computed from the registry configs' shapes), so each budget
here is set from them to pose the JAX test's situation: Flux int8 fits
alone but not beside SDXL, Flux int4 fits beside SDXL int8, and so on."""

import numpy as np
import pytest
import torch

from flux_generator_tpu_torch.io import registry
from flux_generator_tpu_torch.io.params import tree_leaves
from flux_generator_tpu_torch.models.flux.model import init_flux
from flux_generator_tpu_torch.ops.quant import quantize_tree
from flux_generator_tpu_torch.server import memory
from flux_generator_tpu_torch.server.api import FluxAPI
from flux_generator_tpu_torch.server.memory import LADDERS, MemoryPlanner, footprints_gb, model_family

FP = footprints_gb()
T = memory.TRANSIENT_GB
# Flux int8 alone fits; beside SDXL int8 it does not, Flux int4 does
BUDGET = FP[("flux", "int4")] + FP[("sdxl", "int8")] + T + 0.5


def test_budget_poses_the_jax_situation():
    assert FP[("flux", "int8")] + T <= BUDGET
    assert FP[("flux", "int8")] + FP[("sdxl", "int8")] + T > BUDGET
    assert FP[("flux", "int4")] + FP[("sdxl", "int8")] + T <= BUDGET
    assert FP[("flux", "int4")] + FP[("sdxl", "int8")] + FP[("musicgen", "int8")] + T > BUDGET
    assert FP[("flux", "bf16")] + T > BUDGET


def test_model_family():
    assert model_family("flux-schnell") == "flux"
    assert model_family("stabilityai/sdxl-turbo") == "sdxl"
    assert model_family("stabilityai/stable-diffusion-2-1-base") == "sd"
    assert model_family("musicgen") == "musicgen"


def test_single_family_gets_best_fitting_tier():
    assert MemoryPlanner(budget_gb=BUDGET).plan("flux", "flux-schnell").policy == "int8"
    assert not MemoryPlanner(budget_gb=BUDGET).plan("flux", "flux-schnell").evict
    # an 80 GB card keeps every family at full precision
    for slot, model in (("flux", "flux-schnell"), ("sd", "stabilityai/sdxl-turbo"),
                        ("sd", "stabilityai/stable-diffusion-2-1-base"), ("musicgen", "musicgen")):
        assert MemoryPlanner(budget_gb=80.0).plan(slot, model).policy == "bf16"
    assert MemoryPlanner(budget_gb=BUDGET).plan("sd", "stabilityai/stable-diffusion-2-1-base").policy == "bf16"


def test_multi_model_adaptation_converges_to_coresidency():
    pl = MemoryPlanner(budget_gb=BUDGET)
    p1 = pl.plan("flux", "flux-schnell")
    assert p1.policy == "int8"
    pl.note_load("flux", "flux-schnell", None, p1.policy)
    p2 = pl.plan("sd", "stabilityai/sdxl-turbo")
    assert p2.evict == ["flux"]
    pl.note_evict("flux")
    pl.note_load("sd", "stabilityai/sdxl-turbo", None, p2.policy)
    p3 = pl.plan("flux", "flux-schnell")
    assert p3.policy == "int4" and not p3.evict
    pl.note_load("flux", "flux-schnell", None, p3.policy)
    assert set(pl.slots) == {"flux", "sd"}
    assert sum(s.gb for s in pl.slots.values()) + pl.transient_gb <= pl.budget_gb


def test_expect_skips_adaptation_reloads():
    pl = MemoryPlanner(budget_gb=BUDGET)
    pl.expect(["flux", "sdxl"])
    p = pl.plan("flux", "flux-schnell")
    assert p.policy == "int4" and not p.evict
    pl.note_load("flux", "flux-schnell", None, p.policy)
    assert not pl.plan("sd", "stabilityai/sdxl-turbo").evict


def test_lru_eviction_order():
    pl = MemoryPlanner(budget_gb=BUDGET)
    pl.note_load("flux", "flux-schnell", None, "int4")
    pl.note_load("sd", "stabilityai/sdxl-turbo", None, "int8")
    pl.note_use("flux")  # sd is now the least recently used
    plan = pl.plan("musicgen", "musicgen")
    assert plan.evict == ["sd"] and plan.policy == "int8"
    pl.note_use("sd")  # now flux is
    assert pl.plan("musicgen", "musicgen").evict == ["flux"]


def test_measured_footprint_overrides_estimate():
    class _Pipe:
        params = {"w": np.zeros((1024, 1024), np.float32)}  # 4 MiB

    pl = MemoryPlanner(budget_gb=BUDGET)
    pl.note_load("flux", "flux-schnell", _Pipe(), "int8")
    assert pl.slots["flux"].gb < 0.01


def test_measure_counts_every_tensor_of_a_music_pipeline():
    class _Codec:
        params = {"c": torch.zeros(250, dtype=torch.float32)}

    class _Pipe:
        params = {"w": torch.zeros(1000, dtype=torch.bfloat16)}
        t5_params = {"t": [torch.zeros(500, dtype=torch.int8)]}
        audio_decoder = _Codec()

    assert MemoryPlanner._measure(_Pipe()) == pytest.approx((2000 + 500 + 1000) / 1e9)


def test_footprint_table_sanity():
    assert set(FP) == {(f, p) for f, ladder in LADDERS.items() for p in ladder}
    for gb in FP.values():
        assert 0 < gb < 40
    assert FP[("flux", "int4")] < FP[("flux", "int8")] < FP[("flux", "bf16")]
    for fam in ("sd", "sdxl", "musicgen"):
        assert FP[(fam, "int8")] < FP[(fam, "bf16")]
    assert memory.FOOTPRINTS_GB is FP


def _bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def test_footprints_count_what_quantize_tree_stores():
    """The int tiers' byte counts equal those of trees quantized by
    ops.quant, checked on a small Flux config (the full ones are only
    counted, never allocated)."""
    from flux_generator_tpu_torch.models.flux.model import tiny_flux_config
    from flux_generator_tpu_torch.ops.quant import default_predicate

    cfg = tiny_flux_config(hidden_size=512, num_heads=4, axes_dim=(32, 48, 48))
    flow = init_flux(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    meta = init_flux(None, cfg, device=torch.device("meta"))
    assert memory._tree_bytes(meta) == _bytes(flow)
    assert memory._tree_bytes(meta, default_predicate) == _bytes(quantize_tree(flow))
    q4 = quantize_tree(flow, bits=4, group_size=128, pack=True)
    assert memory._tree_bytes(meta, default_predicate, bits=4, group_size=128) == _bytes(q4)


def test_flux_estimate_is_the_published_parameter_count():
    """bf16 Flux: the flow's 11.9 B, T5-XXL's 4.76 B, CLIP-L and the VAE, 2
    bytes each (flux-dev, with its guidance embedder)."""
    flow, ae, clip, t5 = registry.flux_configs("flux-dev")
    meta = torch.device("meta")
    n = sum(x.numel() for x in tree_leaves(init_flux(None, flow, device=meta)))
    assert 11.8e9 < n < 12.0e9
    assert FP[("flux", "bf16")] == pytest.approx(33.74, abs=0.01)


def test_no_card_and_no_budget_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="budget_gb"):
        MemoryPlanner()


class _TinyPipe:
    params = {"w": np.zeros((64, 64), np.float32)}


class _CountingFactory:
    def __init__(self):
        self.calls = []

    def flux(self, name):
        self.calls.append(name)
        return _TinyPipe()

    def sd(self, name):
        self.calls.append(name)
        return _TinyPipe()


def test_alternating_flux_sdxl_zero_reloads():
    fac = _CountingFactory()
    api = FluxAPI(pipeline_factory=fac.flux, sd_factory=fac.sd, budget_gb=BUDGET)
    for _ in range(4):
        api.init_pipeline("flux-schnell")
        api.init_pipeline("stabilityai/sdxl-turbo")
    assert fac.calls == ["flux-schnell", "stabilityai/sdxl-turbo"]
    assert set(api.memory.slots) == {"flux", "sd"}


def test_planner_eviction_wired_to_slots():
    fac = _CountingFactory()
    api = FluxAPI(pipeline_factory=fac.flux, sd_factory=fac.sd, budget_gb=BUDGET)
    api.init_pipeline("flux-schnell")
    api.memory.slots["flux"].gb = FP[("flux", "int8")]  # a full-size footprint
    api.init_pipeline("stabilityai/sdxl-turbo")
    assert api.pipeline is None and api.current_flux_model is None
    assert "flux" not in api.memory.slots
    api.memory.slots["sd"].gb = FP[("sdxl", "int8")]
    api.init_pipeline("flux-schnell")
    assert fac.calls.count("flux-schnell") == 2
    assert set(api.memory.slots) == {"flux", "sd"}
