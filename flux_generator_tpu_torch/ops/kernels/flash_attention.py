"""Flash attention with fused RoPE: CUDA kernel (forward) and plain version,
differentiable through kernels E and F (flash_attention_bwd.py).

The forward kernel (csrc/flash_attention.cu, sm_90a) replaces the TPU
kernels `_attn_kernel` / `_flash_kernel` of flux_generator_tpu/ops/pallas/
flash_attention.py. `flash_attention` dispatches on the tensors' device
only: CPU tensors go to `flash_attention_reference`, CUDA tensors to the
kernel, which raises for shapes, dtypes or layouts it does not take. There is
no fallback from one to the other. Its gradient is `_FlashAttention`, the
counterpart of the JAX package's `_flash_core` custom VJP.

Layout: q, k, v (B, L, H, D); cos/sin (B, L, D/2) tables shared by all
heads, in the working dtype. RoPE rotates interleaved pairs (2i, 2i+1).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .flash_attention_bwd import flash_attention_bwd

# Launches of the CUDA kernel since the last reset (the plain version on CPU
# tensors does not count).
launches = 0

SOURCE = "flux_generator_tpu_torch/csrc/flash_attention.cu"
REPLACES = "flux_generator_tpu/ops/pallas/flash_attention.py:258"
HEAD_DIMS = (64, 128)

_P = ctypes.c_void_p
_SIGNATURES = {
    "fgt_flash_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_float, _P],
}


def _rope_f32(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs of x (B, L, H, D) in f32 with (B, L, D/2)
    tables — the kernel's in-register rotation."""
    shape = x.shape
    xp = x.float().reshape(*shape[:-1], shape[-1] // 2, 2)
    e, o = xp[..., 0], xp[..., 1]
    c = cos.float()[:, :, None, :]
    s = sin.float()[:, :, None, :]
    return torch.stack([e * c - o * s, e * s + o * c], dim=-1).reshape(shape)


def flash_attention_reference(q, k, v, cos=None, sin=None, scale: Optional[float] = None):
    """Plain PyTorch version of the kernel's function → (out, lse).

    out (B, L, H, D) in q's dtype, lse (B·H, L) f32. RoPE in f32 with the
    tables rounded to the working dtype, q/k rounded back to it; f32 logits
    and softmax; P rounded to the working dtype before P·V; O divided by the
    f32 row sum."""
    b, l, h, d = q.shape
    dt = q.dtype
    if scale is None:
        scale = d ** -0.5
    if cos is not None:
        cos, sin = cos.to(dt), sin.to(dt)
        q = _rope_f32(q, cos, sin).to(dt)
        k = _rope_f32(k, cos, sin).to(dt)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(dt).float(), v.float()) / denom
    lse = (m + torch.log(denom)).reshape(b * h, l)
    return o.permute(0, 2, 1, 3).to(dt), lse


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


def _flash_attention_cuda(q, k, v, cos, sin, scale):
    global launches
    _check_cuda_args(q, k, v, cos, sin)
    b, l, h, d = q.shape
    lib = _build.load("flash_attention", _SIGNATURES)
    if cos is not None:  # tables in the working dtype, as the JAX wrapper casts them
        cos = cos.to(q.dtype).contiguous()
        sin = sin.to(q.dtype).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b * h, l), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.fgt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if cos is None else cos.data_ptr(), None if sin is None else sin.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, l, h, d, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check("fgt_flash_attention_fwd", err)
    launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """Forward kernel (or its plain version) with the flash backward, as
    `_flash_core_fwd` / `_flash_core_bwd` of the JAX package: the backward
    rotates q and k once with the tables, forms dvec = rowsum(dO·O) in f32,
    runs dQ and dK/dV on the rotated q/k, and pulls dq and dk back through
    the (orthogonal) rotation with (cos, −sin). cos/sin get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, scale):
        if q.device.type == "cuda":
            out, lse = _flash_attention_cuda(q, k, v, cos, sin, scale)
        elif q.device.type == "cpu":
            out, lse = flash_attention_reference(q, k, v, cos, sin, scale)
        else:
            raise ValueError(f"no flash attention for device {q.device}")
        ctx.save_for_backward(q, k, v, cos, sin, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, cos, sin, out, lse = ctx.saved_tensors
        b, l, h, _ = q.shape
        dt = q.dtype
        if cos is not None:  # the tables as the forward rounds them
            cos, sin = cos.to(dt), sin.to(dt)
            q, k = _rope_f32(q, cos, sin).to(dt), _rope_f32(k, cos, sin).to(dt)
        dout = dout.contiguous()
        dvec = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, l).contiguous()
        dq, dk, dv = flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), dout,
                                         lse, dvec, ctx.scale)
        if cos is not None:
            dq, dk = _rope_f32(dq, cos, -sin).to(dt), _rope_f32(dk, cos, -sin).to(dt)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, cos=None, sin=None, scale: Optional[float] = None,
                    return_lse: bool = False):
    """softmax(rope(q)·rope(k)ᵀ·scale)·v over (B, L, H, D); scale defaults to
    D^-½, RoPE applies when cos/sin (B, L, D/2) are given. Returns out, or
    (out, lse) with lse (B·H, L) f32 when return_lse. Differentiable in q, k
    and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if (cos is None) != (sin is None):
        raise ValueError("pass both RoPE tables or neither")
    out, lse = _FlashAttention.apply(q, k, v, cos, sin, float(scale))
    return (out, lse) if return_lse else out
