"""Flash-attention backward: CUDA kernels E (dQ) and F (dK, dV) and their
plain version.

The kernels (csrc/flash_attention_bwd.cu, sm_90a) replace the TPU kernels
`_bwd_dq_kernel` and `_bwd_dkv_kernel` of flux_generator_tpu/ops/pallas/
flash_attention.py. Both take the RoPE-ROTATED q and k, v, the output
gradient, the forward's logsumexp lse and dvec = rowsum(dO ∘ O); the rotation
and its pull-back happen outside, in the autograd function of
flash_attention.py. `flash_attention_bwd` dispatches on the tensors' device
only: CPU tensors go to `flash_attention_bwd_reference`, CUDA tensors to the
two kernels, which raise for shapes, dtypes or layouts they do not take.
There is no fallback from one to the other.

Layout: q, k, v, do (B, L, H, D); lse, dvec (B·H, L) f32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches of each CUDA kernel since the last reset (the plain version on CPU
# tensors does not count).
dq_launches = 0
dkv_launches = 0

SOURCE = "flux_generator_tpu_torch/csrc/flash_attention_bwd.cu"
REPLACES_DQ = "flux_generator_tpu/ops/pallas/flash_attention.py:438"
REPLACES_DKV = "flux_generator_tpu/ops/pallas/flash_attention.py:452"
HEAD_DIMS = (64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k, v, do, lse, dvec, dq, B, L, H, D, scale, stream
    "fgt_flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P],
    # q, k, v, do, lse, dvec, dk, dv, B, L, H, D, scale, stream
    "fgt_flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    ctypes.c_float, _P],
}


def flash_attention_bwd_reference(qr, kr, v, do, lse, dvec, scale: float):
    """Plain PyTorch version of the two kernels → (dq, dk, dv), each (B, L,
    H, D) in q's dtype, gradients with respect to the rotated q and k.

    The TPU kernels' math in f32: P = exp(q·kᵀ·scale − lse), dP = dO·vᵀ,
    dS = P ∘ (dP − dvec); dq = dS·k·scale, dk = dSᵀ·q·scale, dv = Pᵀ·dO."""
    b, l, h, _ = qr.shape
    qf, kf, vf, of = qr.float(), kr.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.reshape(b, h, l, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", of, vf)
    ds = p * (dp - dvec.reshape(b, h, l, 1))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, of)
    dt = qr.dtype
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check_cuda_args(qr, kr, v, do, lse, dvec):
    tensors = (qr, kr, v, do)
    if any(x.dtype != torch.bfloat16 for x in tensors):
        raise ValueError("flash backward kernels take bf16 q/k/v/do, got "
                         + "/".join(str(x.dtype) for x in tensors))
    if qr.dim() != 4 or any(x.shape != qr.shape for x in tensors):
        raise ValueError("flash backward kernels take equal (B, L, H, D) q/k/v/do, got "
                         + "/".join(str(tuple(x.shape)) for x in tensors))
    b, l, h, d = qr.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash backward kernels take head dim {HEAD_DIMS}, got {d}")
    for name, x in (("lse", lse), ("dvec", dvec)):
        if x.dtype != torch.float32 or x.shape != (b * h, l):
            raise ValueError(f"{name} must be (B·H, L) = {(b * h, l)} f32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if not all(x.is_contiguous() for x in (*tensors, lse, dvec)):
        raise ValueError("flash backward kernels take contiguous tensors")
    if any(x.device != qr.device for x in (*tensors, lse, dvec)):
        raise ValueError("all flash backward operands must lie on one device")


def flash_attention_bwd_dq_cuda(qr, kr, v, do, lse, dvec, scale):
    """Kernel E alone → dq (B, L, H, D) bf16."""
    global dq_launches
    _check_cuda_args(qr, kr, v, do, lse, dvec)
    b, l, h, d = qr.shape
    lib = _build.load("flash_attention_bwd", _SIGNATURES)
    dq = torch.empty_like(qr)
    with torch.cuda.device(qr.device):
        err = lib.fgt_flash_attention_bwd_dq(
            qr.data_ptr(), kr.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dvec.data_ptr(), dq.data_ptr(), b, l, h, d, float(scale),
            torch.cuda.current_stream(qr.device).cuda_stream)
    _build.check("fgt_flash_attention_bwd_dq", err)
    dq_launches += 1
    return dq


def flash_attention_bwd_dkv_cuda(qr, kr, v, do, lse, dvec, scale):
    """Kernel F alone → (dk, dv), each (B, L, H, D) bf16."""
    global dkv_launches
    _check_cuda_args(qr, kr, v, do, lse, dvec)
    b, l, h, d = qr.shape
    lib = _build.load("flash_attention_bwd", _SIGNATURES)
    dk = torch.empty_like(kr)
    dv = torch.empty_like(v)
    with torch.cuda.device(qr.device):
        err = lib.fgt_flash_attention_bwd_dkv(
            qr.data_ptr(), kr.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, l, h, d, float(scale),
            torch.cuda.current_stream(qr.device).cuda_stream)
    _build.check("fgt_flash_attention_bwd_dkv", err)
    dkv_launches += 1
    return dk, dv


def flash_attention_bwd(qr, kr, v, do, lse, dvec, scale: float):
    """(dq, dk, dv) with respect to the rotated q and k: kernels E and F on
    CUDA tensors, the plain version on CPU tensors."""
    if qr.device.type == "cuda":
        dq = flash_attention_bwd_dq_cuda(qr, kr, v, do, lse, dvec, scale)
        return (dq, *flash_attention_bwd_dkv_cuda(qr, kr, v, do, lse, dvec, scale))
    if qr.device.type == "cpu":
        return flash_attention_bwd_reference(qr, kr, v, do, lse, dvec, scale)
    raise ValueError(f"no flash attention backward for device {qr.device}")
