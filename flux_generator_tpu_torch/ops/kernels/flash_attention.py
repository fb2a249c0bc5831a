"""Flash attention with RoPE: CUDA kernels (forward) and plain version,
differentiable through kernels E and F (flash_attention_bwd.py).

The forward kernels replace the TPU kernels `_attn_kernel` / `_flash_kernel`
of flux_generator_tpu/ops/pallas/flash_attention.py. `flash_attention`
dispatches on the tensors' device only: CPU tensors go to
`flash_attention_reference`, CUDA tensors to a kernel, which raises for
shapes, dtypes or layouts it does not take. There is no fallback from one to
the other. Its gradient is `_FlashAttention`, the counterpart of the JAX
package's `_flash_core` custom VJP.

The bf16 mode (`int8=""`) is `bf16_forward`: the RoPE pre-pass
(`rope_rotate`) rotates q and k once, as the JAX wrapper pre-rotates them
past 6144 tokens, and `flash_attention_sm90` (csrc/flash_attention_sm90.cu:
wgmma, a TMA ring) attends over the rotated tensors. The int8 tiers run the
fused-RoPE kernel of csrc/flash_attention.cu.

`int8` selects the int8 tiers of the TPU kernel (`int8_mxu`, the one-shot
path's semantics): "qk" quantizes q and k rows for an int8 Q·Kᵀ, "full" also
p (against the row's final max) and V's columns for an int8 P·V. Like the
JAX wrapper, a sequence longer than the one-shot path's 6144 drops them. A
gradient through a tier is the JAX package's straight-through estimate: the
bf16 backward run on the tier's out and lse.

The backward (`flash_attention_backward`) rotates q and k with the same
pre-pass, runs kernels E and F of flash_attention_bwd.py, and pulls dq and
dk back with the pre-pass at (cos, −sin).

`flash_attention_streamed` is the counterpart of the JAX `_flash_attention_jit`
on its streamed path, where the tiers run at any length: "" and "qk" are A's
modes above (their function does not depend on how keys are blocked), and
"full" is A's streamed mode, which quantizes p and V per group of `blk_k`
keys as the streamed TPU kernel does (`streamed_full_reference`). It has the
same gradient through `_FlashAttention`.

Layout: q, k, v (B, L, H, D); cos/sin (B, L, D/2) tables shared by all
heads, in the working dtype. RoPE rotates interleaved pairs (2i, 2i+1).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .flash_attention_bwd import flash_attention_bwd

# Launches of kernel A since the last reset, one a call in every mode (the
# plain version on CPU tensors does not count); of its int8 tiers alone
# ("full_streamed": the "full" tier in groups of blk_k keys); and of the
# bf16 mode's RoPE pre-pass (two a backward with tables: the rotation and
# the pull-back).
launches = 0
int8_launches = {"qk": 0, "full": 0, "full_streamed": 0}
rope_launches = 0

SOURCE = "flux_generator_tpu_torch/csrc/flash_attention_sm90.cu"  # the bf16 mode and its pre-pass
INT8_SOURCE = "flux_generator_tpu_torch/csrc/flash_attention.cu"
REPLACES = "flux_generator_tpu/ops/pallas/flash_attention.py:258"
REPLACES_STREAMED_FULL = "flux_generator_tpu/ops/pallas/flash_attention.py:292"
HEAD_DIMS = (64, 128)
INT8_TIERS = ("", "qk", "full")
_MODES = {"qk": 1, "full": 2, "full_streamed": 3}
KEY_TILE = 64  # keys per K/V tile of the kernel; a streamed group is whole tiles
# The JAX wrapper keeps the int8 tiers to its one-shot path: a padded length
# of at most 6144 (flash_attention.py:544-551).
INT8_MAX_LEN = 6144

_P = ctypes.c_void_p
_I = ctypes.c_int
_INT8_SIGNATURES = {
    "fgt_flash_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P],
}
_SIGNATURES = {
    "fgt_flash_fwd_sm90": [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P],
    "fgt_rope_rotate": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fgt_flash_fwd_sm90_info": [_I, _P, _P, _P, _P],
}
# the two sources, each built into its own library
BUILDS = {"flash_attention_sm90": _SIGNATURES, "flash_attention": _INT8_SIGNATURES}


def _rope_f32(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs of x (B, L, H, D) in f32 with (B, L, D/2)
    tables — the kernel's in-register rotation."""
    shape = x.shape
    xp = x.float().reshape(*shape[:-1], shape[-1] // 2, 2)
    e, o = xp[..., 0], xp[..., 1]
    c = cos.float()[:, :, None, :]
    s = sin.float()[:, :, None, :]
    return torch.stack([e * c - o * s, e * s + o * c], dim=-1).reshape(shape)


def _quant(x: torch.Tensor, dim: int):
    """int8 levels (as f32) of f32 x with max-abs scales over `dim`: the TPU
    kernel's `_quant_rows` (over D) and `_quant_cols` (over the keys)."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-20) / 127.0
    return torch.clamp(torch.round(x / s), -127, 127), s


def _check_tier(int8: str):
    if int8 not in INT8_TIERS:
        raise ValueError(f"int8 must be one of {INT8_TIERS}, got {int8!r}")


def flash_attention_reference(q, k, v, cos=None, sin=None, scale: Optional[float] = None,
                              int8: str = ""):
    """Plain PyTorch version of the kernel's function → (out, lse).

    out (B, L, H, D) in q's dtype, lse (B·H, L) f32. RoPE in f32 with the
    tables rounded to the working dtype, q/k rounded back to it; f32 logits
    and softmax; P rounded to the working dtype before P·V; O divided by the
    f32 row sum. The int8 tiers (see the module docstring) take their
    integer dots in f64, which holds them exactly."""
    _check_tier(int8)
    b, l, h, d = q.shape
    dt = q.dtype
    if scale is None:
        scale = d ** -0.5
    if cos is not None:
        cos, sin = cos.to(dt), sin.to(dt)
        q = _rope_f32(q, cos, sin).to(dt)
        k = _rope_f32(k, cos, sin).to(dt)
    if int8:
        qi, sq = _quant(q.float(), -1)
        ki, sk = _quant(k.float(), -1)
        dots = torch.einsum("bqhd,bkhd->bhqk", qi.double(), ki.double()).float()
        s = dots * (sq.permute(0, 2, 1, 3) * scale) * sk.permute(0, 2, 3, 1)
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    if int8 == "full":
        vi, sv = _quant(v.float(), 1)
        dots = torch.einsum("bhqk,bkhd->bhqd", torch.round(p * 127.0).double(), vi.double()).float()
        o = dots * (sv.permute(0, 2, 1, 3) / 127.0) / denom
    else:
        o = torch.einsum("bhqk,bkhd->bhqd", p.to(dt).float(), v.float()) / denom
    lse = (m + torch.log(denom)).reshape(b * h, l)
    return o.permute(0, 2, 1, 3).to(dt), lse


def streamed_full_reference(q, k, v, cos=None, sin=None, scale: Optional[float] = None,
                            blk_k: int = 64):
    """Plain version of kernel A's streamed "full" mode: the "full" tier as
    the JAX package's streamed kernel computes it (`_flash_kernel`, run with
    its tiers by `_flash_attention_jit`), in groups of `blk_k` keys from key
    0. Per group: m_new = max(m, the group's max logit), p = exp(s − m_new),
    p_i = rint(p / s_p) with s_p = max(max p, 1e-20)/127, V per column over
    the group's rows, acc = acc·α + (f32(Σ p_i·v_i)·s_p)·s_v and l = l·α + Σ p
    over the unquantized p. The integer dots in f64, which holds them
    exactly → (out, lse) as `flash_attention_reference`."""
    b, l, h, d = q.shape
    dt = q.dtype
    if scale is None:
        scale = d ** -0.5
    if cos is not None:
        cos, sin = cos.to(dt), sin.to(dt)
        q, k = _rope_f32(q, cos, sin).to(dt), _rope_f32(k, cos, sin).to(dt)
    qi, sq = _quant(q.float(), -1)
    ki, sk = _quant(k.float(), -1)
    s = torch.einsum("bqhd,bkhd->bhqk", qi.double(), ki.double()).float()
    s = s * (sq.permute(0, 2, 1, 3) * scale) * sk.permute(0, 2, 3, 1)
    m = torch.full((b, h, l, 1), -torch.inf, device=q.device)
    denom = torch.zeros((b, h, l, 1), device=q.device)
    acc = torch.zeros((b, h, l, d), device=q.device)
    for k0 in range(0, l, blk_k):
        sb = s[..., k0:k0 + blk_k]
        m_new = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sb - m_new)
        denom = denom * alpha + p.sum(dim=-1, keepdim=True)
        sp = p.amax(dim=-1, keepdim=True).clamp_min(1e-20) / 127.0
        vi, sv = _quant(v[:, k0:k0 + blk_k].float(), 1)
        pv = torch.einsum("bhqk,bkhd->bhqd", torch.round(p / sp).double(), vi.double()).float()
        acc = acc * alpha + pv * sp * sv.permute(0, 2, 1, 3)
        m = m_new
    lse = (m + torch.log(denom)).reshape(b * h, l)
    return (acc / denom).permute(0, 2, 1, 3).to(dt), lse


def _check_cuda_args(q, k, v, cos, sin):
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash kernel takes equal (B, L, H, D) q/k/v, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dim {HEAD_DIMS}, got {q.shape[-1]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel takes contiguous q/k/v")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    if (cos is None) != (sin is None):
        raise ValueError("pass both RoPE tables or neither")
    if cos is not None:
        b, l, _, d = q.shape
        if cos.shape != (b, l, d // 2) or sin.shape != (b, l, d // 2):
            raise ValueError(f"RoPE tables must be (B, L, D/2) = {(b, l, d // 2)}, got "
                             f"{tuple(cos.shape)}/{tuple(sin.shape)}")
        if cos.device != q.device or sin.device != q.device:
            raise ValueError("RoPE tables must lie on q's device")


def _check_aligned(*tensors, align: int = 16):
    """TMA (and the pre-pass's vector loads) take base addresses and strides
    in multiples of `align` bytes: raise for a tensor that has another."""
    for t in tensors:
        if t.data_ptr() % align:
            raise ValueError(f"flash kernel takes {align}-byte aligned tensors, got a base address "
                             f"{t.data_ptr():#x} ({t.data_ptr() % align} past {align})")
        if any(st * t.element_size() % align for st in t.stride()[:-1]):
            raise ValueError(f"flash kernel takes strides of {align}-byte multiples, got {t.stride()} "
                             f"elements of {t.element_size()} bytes")


def rope_rotate_reference(q, k, cos, sin):
    """Plain version of the RoPE pre-pass: q and k rotated in f32 with the
    tables rounded to the working dtype, rounded back to it."""
    dt = q.dtype
    cos, sin = cos.to(dt), sin.to(dt)
    return _rope_f32(q, cos, sin).to(dt), _rope_f32(k, cos, sin).to(dt)


def rope_rotate(q, k, cos, sin):
    """The bf16 mode's RoPE pre-pass → (rope(q), rope(k)): its kernel on CUDA
    tensors (new tensors), its plain version on CPU ones."""
    global rope_launches
    if q.device.type == "cpu":
        return rope_rotate_reference(q, k, cos, sin)
    _check_cuda_args(q, k, q, cos, sin)
    b, l, h, d = q.shape
    cos = cos.to(q.dtype).contiguous()
    sin = sin.to(q.dtype).contiguous()
    _check_aligned(q, k)
    _check_aligned(cos, sin, align=8)
    lib = _build.load("flash_attention_sm90", _SIGNATURES)
    qr, kr = torch.empty_like(q), torch.empty_like(k)
    with torch.cuda.device(q.device):
        err = lib.fgt_rope_rotate(q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(), qr.data_ptr(),
                                  kr.data_ptr(), b, l, h, d, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("fgt_rope_rotate", err)
    rope_launches += 1
    return qr, kr


def flash_attention_sm90(q, k, v, scale: Optional[float] = None):
    """Attention without RoPE in bf16 → (out, lse): the kernel of
    csrc/flash_attention_sm90.cu on CUDA tensors, the plain version on CPU
    ones."""
    global launches
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale=scale)
    _check_cuda_args(q, k, v, None, None)
    _check_aligned(q, k, v)
    b, l, h, d = q.shape
    lib = _build.load("flash_attention_sm90", _SIGNATURES)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, l), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.fgt_flash_fwd_sm90(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                                     b, l, h, d, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("fgt_flash_fwd_sm90", err)
    launches += 1
    return out, lse


def sm90_kernel_info(d: int = 128) -> dict:
    """The attention kernel's registers a thread at launch, spilled bytes a
    thread, shared memory a block and blocks an SM at head dim d (on the
    current CUDA device)."""
    lib = _build.load("flash_attention_sm90", _SIGNATURES)
    vals = [ctypes.c_int(0) for _ in range(4)]
    _build.check("fgt_flash_fwd_sm90_info", lib.fgt_flash_fwd_sm90_info(d, *(ctypes.byref(x) for x in vals)))
    return dict(zip(("registers", "spill_bytes", "smem_bytes", "blocks_per_sm"), (x.value for x in vals)))


def bf16_forward(q, k, v, cos, sin, scale):
    """Kernel A's bf16 mode → (out, lse): the RoPE pre-pass when tables are
    given, then attention over the rotated q and k."""
    if (cos is None) != (sin is None):
        raise ValueError("pass both RoPE tables or neither")
    if cos is not None:
        q, k = rope_rotate(q, k, cos, sin)
    return flash_attention_sm90(q, k, v, scale)


def _flash_attention_cuda(q, k, v, cos, sin, scale, int8, group: int = 0):
    """Kernel A's int8 tier `int8` ("qk", "full" or "full_streamed", whose
    quantization groups are `group` keys), fused RoPE."""
    global launches
    _check_cuda_args(q, k, v, cos, sin)
    b, l, h, d = q.shape
    if int8 not in _MODES:
        raise ValueError(f"the int8 kernel's modes are {tuple(_MODES)}, got {int8!r}")
    if int8 == "full_streamed" and (group <= 0 or group % KEY_TILE):
        raise ValueError(f"the streamed full tier takes groups of a positive multiple of {KEY_TILE} keys, "
                         f"got {group}")
    lib = _build.load("flash_attention", _INT8_SIGNATURES)
    if cos is not None:  # tables in the working dtype, as the JAX wrapper casts them
        cos = cos.to(q.dtype).contiguous()
        sin = sin.to(q.dtype).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b * h, l), dtype=torch.float32, device=q.device)
    # V's column amax for the "full" tiers (over the head, or per group),
    # combined with atomicMax from zero
    groups = {"full": 1, "full_streamed": -(-l // max(group, 1))}.get(int8, 0)
    vamax = torch.zeros((b * h, groups, d), dtype=torch.int32, device=q.device) if groups else None
    with torch.cuda.device(q.device):
        err = lib.fgt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if cos is None else cos.data_ptr(), None if sin is None else sin.data_ptr(),
            None if vamax is None else vamax.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, l, h, d, float(scale), _MODES[int8], group,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check("fgt_flash_attention_fwd", err)
    launches += 1
    int8_launches[int8] += 1
    return out, lse


def _forward(q, k, v, cos, sin, scale, int8):
    """Kernel A on CUDA tensors, its plain version on CPU ones → (out, lse)."""
    if q.device.type == "cuda":
        if not int8:
            return bf16_forward(q, k, v, cos, sin, scale)
        return _flash_attention_cuda(q, k, v, cos, sin, scale, int8)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, cos, sin, scale, int8)
    raise ValueError(f"no flash attention for device {q.device}")


def flash_attention_backward(q, k, v, cos, sin, out, lse, dout, scale: float):
    """The backward of `flash_attention` (int8 = "") → (dq, dk, dv), as
    `_flash_core_bwd` of the JAX package: rotate q and k with the tables
    (the RoPE pre-pass), form dvec = rowsum(dO·O) in f32, run kernels E and F
    (their plain version on CPU tensors) on the rotated q/k, and pull dq and
    dk back through the (orthogonal) rotation with (cos, −sin), the pre-pass
    again. Negating a table is exact, so the pull-back is the rotation's
    transpose in the working dtype."""
    b, l, h, _ = q.shape
    if cos is not None:
        q, k = rope_rotate(q, k, cos, sin)
    dout = dout.contiguous()
    dvec = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, l).contiguous()
    dq, dk, dv = flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), dout, lse, dvec, scale)
    if cos is not None:
        dq, dk = rope_rotate(dq, dk, cos, -sin)
    return dq, dk, dv


def _streamed_forward(q, k, v, cos, sin, scale, int8, blk_k):
    """The streamed path's forward → (out, lse): "" and "qk" as `_forward`,
    "full" A's streamed mode (`streamed_full_reference` on CPU tensors)."""
    if int8 != "full":
        return _forward(q, k, v, cos, sin, scale, int8)
    if q.device.type == "cuda":
        return _flash_attention_cuda(q, k, v, cos, sin, scale, "full_streamed", blk_k)
    if q.device.type == "cpu":
        return streamed_full_reference(q, k, v, cos, sin, scale, blk_k)
    raise ValueError(f"no flash attention for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """Forward kernel (or its plain version), one-shot or streamed, with the
    flash backward (`flash_attention_backward`), as `_flash_core_fwd` /
    `_flash_core_bwd` of the JAX package. cos/sin get no gradient. An int8
    tier's gradient is the straight-through estimate of the JAX package: the
    bf16 backward run on the tier's out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, scale, int8, blk_k):
        if blk_k:
            out, lse = _streamed_forward(q, k, v, cos, sin, scale, int8, blk_k)
        else:
            out, lse = _forward(q, k, v, cos, sin, scale, int8)
        ctx.save_for_backward(q, k, v, cos, sin, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, cos, sin, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, cos, sin, out, lse, dout, ctx.scale)
        return dq, dk, dv, None, None, None, None, None


def effective_int8(length: int, int8: str) -> str:
    """The int8 tier a call of this length runs: none past the one-shot
    path's length, where the JAX wrapper drops it."""
    _check_tier(int8)
    return int8 if length <= INT8_MAX_LEN else ""


def flash_attention(q, k, v, cos=None, sin=None, scale: Optional[float] = None,
                    return_lse: bool = False, int8: str = ""):
    """softmax(rope(q)·rope(k)ᵀ·scale)·v over (B, L, H, D); scale defaults to
    D^-½, RoPE applies when cos/sin (B, L, D/2) are given. Returns out, or
    (out, lse) with lse (B·H, L) f32 when return_lse. Differentiable in q, k
    and v; "" (the default) is bf16, "qk" and "full" are the int8 tiers,
    whose gradient is the bf16 backward on their out and lse."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if (cos is None) != (sin is None):
        raise ValueError("pass both RoPE tables or neither")
    int8 = effective_int8(q.shape[1], int8)
    out, lse = _FlashAttention.apply(q, k, v, cos, sin, float(scale), int8, 0)
    return (out, lse) if return_lse else out


def flash_attention_streamed(q, k, v, cos=None, sin=None, scale: Optional[float] = None, int8: str = "",
                             blk_k: int = 1024):
    """The JAX `_flash_attention_jit` on its streamed path, whose int8 tiers
    run at any length → (out, lse), lse (B·H, L) f32. "" (`bf16_forward`) and
    "qk" are kernel A's modes; "full" is A's streamed mode, quantizing p and V per group of
    `blk_k` keys (`streamed_full_reference` on CPU tensors). Differentiable in
    q, k and v as `flash_attention`: the bf16 backward on this out and lse."""
    _check_tier(int8)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if (cos is None) != (sin is None):
        raise ValueError("pass both RoPE tables or neither")
    if blk_k <= 0:
        raise ValueError(f"blk_k must be positive, got {blk_k}")
    return _FlashAttention.apply(q, k, v, cos, sin, float(scale), int8, blk_k)
