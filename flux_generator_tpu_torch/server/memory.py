"""Resident-set memory planner for the server's pipeline slots (the port's
copy of flux_generator_tpu/server/memory.py, with the same logic).

Before each load the planner decides

  1. the weight policy of the incoming pipeline: the ladder bf16 → int8 (per
     channel, weight-only) → int4 (groups of 128, packed; Flux only), the
     highest precision whose resident set fits the device's memory, and
  2. which resident slots to evict (least recently used first) when even
     the lowest tier does not fit.

It remembers every family that has been asked for ("pressure"): a family
that is not resident reserves its smallest footprint in later plans, so
alternating families settle where both stay resident; `expect()` declares
the mix up front.

The estimates are the port's own: each (family, policy) footprint is
computed from the parameter shapes of the registry's configs (io/registry)
and the tier's bytes, scales included, with the quantization predicates the
loaders apply (io/loaders). After a load the estimate is replaced by the
pipeline's measured bytes. The device's memory is the card's total.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

# policy ladders per family: only Flux has an int4 tier
LADDERS = {
    "flux": ("bf16", "int8", "int4"),
    "sd": ("bf16", "int8"),
    "sdxl": ("bf16", "int8"),
    "musicgen": ("bf16", "int8"),
}

# head-room for activations and decode buffers above the resident params:
# chip_smoke.py's main-serve phase measures each served request's peak above
# resident memory and fails past this; at most 4.37 GiB (4.69 GB: four
# coalesced 500-step MusicGen-medium requests; one 3.26 GiB; Flux, SD 2.1 and
# SDXL at 512², batch 1 or 4, 1.13 GiB) on an NVIDIA H100 80GB HBM3 at 700 W,
# with full-width bf16 weights
TRANSIENT_GB = 5.0


def model_family(model: str) -> str:
    if model.startswith("stabilityai/"):
        return "sdxl" if "sdxl" in model else "sd"
    if "music" in model:
        return "musicgen"
    return "flux"


def device_hbm_gb() -> float:
    """Total memory of the current CUDA device in GB; raises without a card
    (pass MemoryPlanner a budget_gb on the CPU)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: give MemoryPlanner a budget_gb")
    return torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory / 1e9


# ------------------------------------------------------------ footprints


def _tree_bytes(tree, predicate=None, bits: int = 8, group_size: Optional[int] = None, float_bytes: int = 2):
    """Bytes of a shape tree (meta tensors) with the dense dicts that
    `predicate` accepts quantized as ops.quant stores them: int8 a value
    (int4 packed: half a byte) and f32 scales per output channel, or per
    group of `group_size` inputs; every other floating leaf `float_bytes` a
    value, integer leaves their own size."""
    if isinstance(tree, dict):
        if predicate is not None and "kernel" in tree and tree["kernel"].ndim >= 2 and predicate(tree):
            k = tree["kernel"]
            lead = k.numel() // (k.shape[-2] * k.shape[-1])
            gs = group_size if group_size and k.shape[-2] % group_size == 0 else None
            scales = lead * k.shape[-1] * (k.shape[-2] // gs if gs else 1)
            rest = sum(_tree_bytes(v, None, float_bytes=float_bytes) for n, v in tree.items() if n != "kernel")
            return k.numel() * bits // 8 + 4 * scales + rest
        return sum(_tree_bytes(v, predicate, bits, group_size, float_bytes) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_bytes(v, predicate, bits, group_size, float_bytes) for v in tree)
    return tree.numel() * (float_bytes if tree.is_floating_point() else tree.element_size())


@functools.lru_cache(maxsize=None)
def footprints_gb() -> dict:
    """{(family, policy): GB} of the registry's full configs: Flux (flux-dev,
    the larger by its guidance embedder: flow, T5-XXL, CLIP-L, VAE), SD
    2.1-base and SDXL-Turbo (UNet, VAE, CLIP(s)) and MusicGen-medium
    (decoder, T5-base, EnCodec in f32). The int tiers are the loaders':
    Flux int8 puts flow and T5 in int8, int4 the flow in packed int4 (groups
    of 128) and T5 in int8; SD's int8 the UNet's and first CLIP's denses that
    `_sd_quant_predicate` accepts; MusicGen's int8 the decoder and T5."""
    import torch

    from ..io import registry
    from ..io.loaders import _sd_quant_predicate
    from ..models.clip.text import init_clip_text
    from ..models.flux.autoencoder import init_autoencoder
    from ..models.flux.model import init_flux
    from ..models.musicgen.encodec import init_encodec
    from ..models.musicgen.model import init_musicgen
    from ..models.sd.unet import init_unet
    from ..models.sd.vae import init_sd_vae
    from ..models.t5.t5 import init_t5_encoder
    from ..ops.quant import default_predicate

    meta = torch.device("meta")
    out = {}
    flow_cfg, ae_cfg, clip_cfg, t5_cfg = registry.flux_configs("flux-dev")
    flow, t5 = init_flux(None, flow_cfg, device=meta), init_t5_encoder(None, t5_cfg, device=meta)
    rest = _tree_bytes(init_autoencoder(None, ae_cfg, device=meta)) + _tree_bytes(
        init_clip_text(None, clip_cfg, device=meta))
    out[("flux", "bf16")] = _tree_bytes(flow) + _tree_bytes(t5) + rest
    t5_int8 = _tree_bytes(t5, default_predicate)
    out[("flux", "int8")] = _tree_bytes(flow, default_predicate) + t5_int8 + rest
    out[("flux", "int4")] = _tree_bytes(flow, default_predicate, bits=4, group_size=128) + t5_int8 + rest
    for family, name in (("sd", "stable-diffusion-2-1-base"), ("sdxl", "sdxl-turbo")):
        unet_cfg, vae_cfg, clip_cfgs = registry.sd_configs(name)
        unet, clip = init_unet(None, unet_cfg, device=meta), init_clip_text(None, clip_cfgs[0], device=meta)
        rest = _tree_bytes(init_sd_vae(None, vae_cfg, device=meta)) + sum(
            _tree_bytes(init_clip_text(None, c, device=meta)) for c in clip_cfgs[1:])
        out[(family, "bf16")] = _tree_bytes(unet) + _tree_bytes(clip) + rest
        out[(family, "int8")] = _tree_bytes(unet, _sd_quant_predicate) + _tree_bytes(clip, _sd_quant_predicate) + rest
    mg_cfg, mg_t5_cfg, enc_cfg = registry.musicgen_configs()
    dec, mt5 = init_musicgen(None, mg_cfg, device=meta), init_t5_encoder(None, mg_t5_cfg, device=meta)
    codec = _tree_bytes(init_encodec(None, enc_cfg, device=meta), float_bytes=4)
    out[("musicgen", "bf16")] = _tree_bytes(dec) + _tree_bytes(mt5) + codec
    out[("musicgen", "int8")] = _tree_bytes(dec, default_predicate) + _tree_bytes(mt5, default_predicate) + codec
    return {k: v / 1e9 for k, v in out.items()}


def __getattr__(name):
    if name == "FOOTPRINTS_GB":  # computed at first use: building the shape trees takes seconds
        return footprints_gb()
    raise AttributeError(name)


# ------------------------------------------------------------ planner


@dataclass
class _Slot:
    family: str
    model: str
    gb: float
    policy: str
    last_used: float = field(default_factory=time.monotonic)


@dataclass
class LoadPlan:
    policy: str             # "bf16" | "int8" | "int4" for the incoming load
    evict: List[str]        # slot names to drop before loading
    est_gb: float           # planned resident footprint of the new pipeline

    @property
    def quantize(self) -> bool:
        return self.policy != "bf16"


class MemoryPlanner:
    """Tracks each slot's resident footprint and plans loads against the
    device's memory. Slot names are the FluxAPI slots ("flux", "sd",
    "musicgen")."""

    def __init__(self, budget_gb: Optional[float] = None, transient_gb: float = TRANSIENT_GB):
        self.budget_gb = budget_gb if budget_gb is not None else device_hbm_gb()
        self.transient_gb = transient_gb
        self.slots: Dict[str, _Slot] = {}
        # families ever requested: those not resident reserve their smallest footprint
        self.pressure: set = set()

    def expect(self, families: Iterable[str]) -> None:
        """Declare the model mix up front, so the first loads already plan
        for co-residency."""
        self.pressure.update(families)

    # ------------------------------------------------------------ planning

    def _min_est(self, family: str) -> float:
        return min(self._estimate(family, p) for p in LADDERS[family])

    def plan(self, slot: str, model: str) -> LoadPlan:
        family = model_family(model)
        self.pressure.add(family)
        avail = self.budget_gb - self.transient_gb
        resident = {n: s for n, s in self.slots.items() if n != slot}
        resident_gb = sum(s.gb for s in resident.values())
        resident_fams = {s.family for s in resident.values()}
        reserve = sum(self._min_est(f) for f in self.pressure if f != family and f not in resident_fams)

        for policy in LADDERS[family]:
            if resident_gb + reserve + self._estimate(family, policy) <= avail:
                return LoadPlan(policy, [], self._estimate(family, policy))

        # the lowest tier and the reservation do not fit: plan without
        # reserving for absent families (they adapt when they come back)
        floor = LADDERS[family][-1]
        for policy in LADDERS[family]:
            if resident_gb + self._estimate(family, policy) <= avail:
                return LoadPlan(policy, [], self._estimate(family, policy))

        # still not: evict other slots, least recently used first
        evict = []
        for name in sorted(resident, key=lambda n: resident[n].last_used):
            evict.append(name)
            resident_gb -= resident[name].gb
            if resident_gb + self._estimate(family, floor) <= avail:
                break
        return LoadPlan(floor, evict, self._estimate(family, floor))

    def _estimate(self, family: str, policy: str) -> float:
        table = footprints_gb()
        return table.get((family, policy), table.get((family, "bf16"), 1.0))

    # ------------------------------------------------------------ tracking

    def note_load(self, slot: str, model: str, pipeline, policy: str) -> None:
        """Record a completed load, with the footprint measured from the
        pipeline's tensors where it has any."""
        gb = self._measure(pipeline)
        if gb is None:
            gb = self._estimate(model_family(model), policy)
        self.slots[slot] = _Slot(model_family(model), model, gb, policy)

    def note_use(self, slot: str) -> None:
        if slot in self.slots:
            self.slots[slot].last_used = time.monotonic()

    def note_evict(self, slot: str) -> None:
        self.slots.pop(slot, None)

    @staticmethod
    def _measure(pipeline) -> Optional[float]:
        """GB of every tensor the pipeline holds: `params`, and a MusicGen
        pipeline's `t5_params` and codec params too."""
        params = getattr(pipeline, "params", None)
        if params is None:
            return None
        from ..io.params import tree_leaves

        trees = [params, getattr(pipeline, "t5_params", None),
                 getattr(getattr(pipeline, "audio_decoder", None), "params", None)]
        return sum(getattr(x, "nbytes", 0) for t in trees if t is not None for x in tree_leaves(t)) / 1e9
