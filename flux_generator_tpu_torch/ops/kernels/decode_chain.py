"""The decode-chain probe: CUDA kernel (#11) and plain version.

The kernel (csrc/decode_chain.cu, sm_90a) replaces the TPU kernel `_kernel`
of scripts/prof_pallas_chain.py (pallas_call at :150): kernel D's weight
stream — the same packed chunks, w (L·14, H, H) int8 and s (L·14, 1, H)
bf16 — on D's own machinery (csrc/decode_ring.cuh: D's schedule, TMA weight
ring and mma.sync products, with D's ticketed folds), with attention as
identity, in six grid syncs a layer. Its time on the card is what D's
design pays to move the weights, and D's time less it is what D's attention
and its seventh sync cost.

Contract: `decode_chain(w, s, x (M, H) bf16) → (M, H) bf16`, for every layer:
LN (no affine, eps 1e-5) → q = c0, c1 and c2 computed and parked; x += c3·q;
LN → x += c5·(c4·LN); LN → up c6..c9 → exact GELU per chunk → x += Σ c10..c13.
Dots round their inputs to bf16 and dequantize w.bf16 · s.bf16 to bf16, with
f32 accumulation; the residual stays f32. `decode_chain` dispatches on the
tensors' device: CPU tensors go to `decode_chain_plain` (the port of the
script's `jnp_chain`, l.176-205), CUDA tensors to the kernel, which raises
for what it does not take: 1..8 rows, H a multiple of 256 up to 8192 (D's
256-row weight tiles), w and s 16-byte aligned (the TMA map and the scales'
16-byte copies).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_step import CPL, MAX_BATCH, MAX_HIDDEN, _bf, _ln_f32

# Launches of the CUDA kernel since the last reset (the plain version on CPU
# tensors does not count).
launches = 0

SOURCE = "flux_generator_tpu_torch/csrc/decode_chain.cu"
REPLACES = "scripts/prof_pallas_chain.py:150"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fgt_decode_chain": [_P] * 5 + [_I] * 3 + [_P, _P],  # w, s, x, y, scratch, L, B, H, timers, stream
    "fgt_decode_chain_scratch_floats": [_I, _I],         # B, H
    # → registers, local bytes, shared bytes, blocks an SM, ring stages, syncs a layer
    "fgt_decode_chain_info": [_P] * 6,
}
# grid syncs a layer: qkv | o + residual | cross q | cross o + residual | up + GELU | down + residual
PHASE_NAMES = ("qkv", "o + residual", "cross q", "cross o + residual", "up + GELU", "down + residual")
SYNCS_PER_LAYER = len(PHASE_NAMES)


def decode_chain_plain(w, s, x):
    """Plain PyTorch version: the script's `jnp_chain`, layer by layer."""
    n_layers = w.shape[0] // CPL
    h = x.shape[-1]
    ones, zeros = torch.ones(h, device=x.device), torch.zeros(h, device=x.device)
    xs = x.float()
    for li in range(n_layers):
        def mm(a, c, li=li):
            k = (w[li * CPL + c].to(torch.bfloat16) * s[li * CPL + c].to(torch.bfloat16)).float()
            return _bf(a) @ k

        lns = _ln_f32(xs, ones, zeros)
        q = mm(lns, 0)
        park = mm(lns, 1) + mm(lns, 2)  # the k/v projections: traffic, not results
        xs = xs + mm(q, 3) + 0.0 * park[:, :1]
        lns = _ln_f32(xs, ones, zeros)
        xs = xs + mm(mm(lns, 4), 5)
        lns = _ln_f32(xs, ones, zeros)
        hs = torch.cat([mm(lns, 6 + j) for j in range(4)], dim=-1)
        g = torch.nn.functional.gelu(hs, approximate="none")
        xs = xs + sum(mm(g[:, j * h:(j + 1) * h], 10 + j) for j in range(4))
    return xs.to(x.dtype)


def _check_cuda_args(w, s, x):
    if w.dtype != torch.int8 or s.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise ValueError(f"decode-chain kernel takes int8 w, bf16 s and x, got {w.dtype}, {s.dtype}, "
                         f"{x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (M, H), got {tuple(x.shape)}")
    m, h = x.shape
    if w.dim() != 3 or w.shape[1:] != (h, h) or w.shape[0] % CPL or w.shape[0] == 0:
        raise ValueError(f"w must be (L·{CPL}, H, H) with H = {h}, got {tuple(w.shape)}")
    if s.shape != (w.shape[0], 1, h):
        raise ValueError(f"s must be ({w.shape[0]}, 1, {h}), got {tuple(s.shape)}")
    if not 1 <= m <= MAX_BATCH or h % 256 or h > MAX_HIDDEN:
        raise ValueError(f"decode-chain kernel takes 1..{MAX_BATCH} rows and H a multiple of 256 up to "
                         f"{MAX_HIDDEN} (its weight tiles are 256 rows), got ({m}, {h})")
    if any(not t.is_contiguous() for t in (w, s, x)) or any(t.device != x.device for t in (w, s)):
        raise ValueError("decode-chain kernel takes contiguous tensors on one device")
    if w.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError("decode-chain kernel reads w through a TMA map and s in 16-byte copies: both must be "
                         "16-byte aligned")


def _decode_chain_cuda(w, s, x, timers=None):
    global launches
    _check_cuda_args(w, s, x)
    m, h = x.shape
    lib = _build.load("decode_chain", _SIGNATURES)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        n_scratch = lib.fgt_decode_chain_scratch_floats(m, h)
        if n_scratch <= 0:
            raise RuntimeError("decode-chain kernel: no launch plan for this device and shape")
        scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
        err = lib.fgt_decode_chain(w.data_ptr(), s.data_ptr(), x.data_ptr(), y.data_ptr(),
                                   scratch.data_ptr(), w.shape[0] // CPL, m, h,
                                   None if timers is None else timers.data_ptr(),
                                   torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("fgt_decode_chain", err)
    launches += 1
    return y


def kernel_info() -> dict:
    """The kernel on the current card: registers a thread, local memory bytes
    a thread, shared memory bytes a block, blocks an SM, weight-ring stages,
    grid syncs a layer."""
    lib = _build.load("decode_chain", _SIGNATURES)
    vals = [ctypes.c_int() for _ in range(6)]
    _build.check("fgt_decode_chain_info", lib.fgt_decode_chain_info(*(ctypes.byref(v) for v in vals)))
    keys = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "ring_stages", "syncs_per_layer")
    return dict(zip(keys, (v.value for v in vals)))


def phase_times(w, s, x) -> dict:
    """One launch of the kernel on CUDA tensors with block 0 stamping the
    device clock after each grid sync → {phase name: µs summed over the
    layers}, each phase from the sync before it to the sync after it (the
    last layer's down until block 0 ends; the set-up before the first sync
    is not counted). The launch counts."""
    n_layers = w.shape[0] // CPL
    stamps = torch.zeros(SYNCS_PER_LAYER * n_layers + 1, dtype=torch.int64, device=x.device)
    _decode_chain_cuda(w, s, x, stamps)
    d = stamps.diff().double().cpu().reshape(n_layers, SYNCS_PER_LAYER) / 1e3
    return dict(zip(PHASE_NAMES, d.sum(0).tolist()))


def decode_chain(w, s, x):
    """One step of the chain through all L layers → (M, H) in x's dtype."""
    if x.device.type == "cuda":
        return _decode_chain_cuda(w, s, x)
    if x.device.type == "cpu":
        return decode_chain_plain(w, s, x)
    raise ValueError(f"no decode chain for device {x.device}")
