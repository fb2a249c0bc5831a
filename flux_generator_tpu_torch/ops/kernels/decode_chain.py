"""The decode-chain probe: CUDA kernel (#11) and plain version.

The kernel (csrc/decode_chain.cu, sm_90a) replaces the TPU kernel `_kernel`
of scripts/prof_pallas_chain.py (pallas_call at :150): kernel D's weight
stream — the same packed chunks, w (L·14, H, H) int8 and s (L·14, 1, H)
bf16, in the same 14-chunk schedule — with attention as identity. Its time
on the card is D's floor for streaming the weights.

Contract: `decode_chain(w, s, x (M, H) bf16) → (M, H) bf16`, for every layer:
LN (no affine, eps 1e-5) → q = c0, c1 and c2 computed and parked; x += c3·q;
LN → x += c5·(c4·LN); LN → up c6..c9 → exact GELU per chunk → x += Σ c10..c13.
Dots round their inputs to bf16 and dequantize w.bf16 · s.bf16 to bf16, with
f32 accumulation; the residual stays f32. `decode_chain` dispatches on the
tensors' device: CPU tensors go to `decode_chain_plain` (the port of the
script's `jnp_chain`, l.176-205), CUDA tensors to the kernel.
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
    "fgt_decode_chain": [_P] * 5 + [_I] * 3 + [_P],  # w, s, x, y, scratch, L, B, H, stream
    "fgt_decode_chain_scratch_floats": [_I, _I],     # B, H
}


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
                         f"{MAX_HIDDEN}, got ({m}, {h})")
    if any(not t.is_contiguous() for t in (w, s, x)) or any(t.device != x.device for t in (w, s)):
        raise ValueError("decode-chain kernel takes contiguous tensors on one device")


def _decode_chain_cuda(w, s, x):
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
                                   torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("fgt_decode_chain", err)
    launches += 1
    return y


def decode_chain(w, s, x):
    """One step of the chain through all L layers → (M, H) in x's dtype."""
    if x.device.type == "cuda":
        return _decode_chain_cuda(w, s, x)
    if x.device.type == "cpu":
        return decode_chain_plain(w, s, x)
    raise ValueError(f"no decode chain for device {x.device}")
