"""Functional dense / conv primitives over plain-dict params (counterpart of
flux_generator_tpu/ops/linear.py).

Layouts are the JAX package's, kept at every public function: dense kernels
are (in_features, out_features), 2-D convs take NHWC activations and HWIO
kernels, 1-D convs NHC activations and HIO kernels. The convs transpose to
torch's channels-first layouts inside; an NHWC tensor permuted to NCHW is
torch's channels_last layout, so cuDNN runs it without a copy.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.mesh import MODEL_AXIS, all_gather, all_reduce
from .kernels import w8a8_matmul as w8a8_kernels
from .kernels import int4_matmul as int4_kernels
from .quant import INT4_MARK, is_k_major


def _rand_uniform(shape, bound, dtype, device, generator):
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return ((u * 2 - 1) * bound).to(dtype)


def rand_normal(generator, shape, std, dtype, device):
    """N(0, std²) draws (embedding tables, T5 relative bias)."""
    return (torch.randn(shape, generator=generator, device=device, dtype=torch.float32) * std).to(dtype)


def init_dense(generator, in_features: int, out_features: int, bias: bool = True,
               dtype=torch.float32, device=None):
    """U(-1/√in, 1/√in) kernel (in, out) and bias, as the JAX init draws
    them (the streams differ: torch cannot replay jax.random)."""
    scale = 1.0 / (in_features ** 0.5)
    p = {"kernel": _rand_uniform((in_features, out_features), scale, dtype, device, generator)}
    if bias:
        p["bias"] = _rand_uniform((out_features,), scale, dtype, device, generator)
    return p


def init_conv2d(generator, in_ch: int, out_ch: int, kernel_size, bias: bool = True,
                dtype=torch.float32, device=None):
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size, kernel_size)
    scale = 1.0 / ((in_ch * kernel_size[0] * kernel_size[1]) ** 0.5)
    p = {"kernel": _rand_uniform((*kernel_size, in_ch, out_ch), scale, dtype, device, generator)}
    if bias:
        p["bias"] = _rand_uniform((out_ch,), scale, dtype, device, generator)
    return p


def _dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int weights + per-channel (…, out) or per-group (…, g, out) scales →
    `dtype` kernel; the scale is rounded to `dtype` before the multiply, as
    in the JAX package."""
    if scale.ndim == q.ndim:  # grouped
        g = scale.shape[-2]
        gs = q.shape[-2] // g
        w = q.reshape(*q.shape[:-2], g, gs, q.shape[-1]).to(dtype) * scale[..., :, None, :].to(dtype)
        return w.reshape(q.shape)
    return q.to(dtype) * scale.to(dtype)[..., None, :]


def _int4(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x @ packed int4 (…, K/2, N), routed as the JAX package's `dense`
    routes it on the TPU (flux_generator_tpu/ops/linear.py:99-132): kernel B
    (or its plain version on the CPU) for a 2-D kernel whose layout its TPU
    kernel takes (`supported`), else the two-halves formulation, each half
    dequantized in x's dtype with the scales rounded to it, and the two
    products taken in x's dtype."""
    if q4.dim() == 2 and int4_kernels.supported(x.shape[-1], scale):
        return int4_kernels.int4_matmul(x, q4, scale)
    half = q4.shape[-2]
    lo = (q4 & 0xF).to(torch.int8) - 8
    hi = (q4 >> 4).to(torch.int8) - 8
    if scale.dim() == q4.dim():  # grouped: the first g/2 groups belong to the low half
        g2 = scale.shape[-2] // 2
        s_lo, s_hi = scale[..., :g2, :], scale[..., g2:, :]
    else:
        s_lo = s_hi = scale
    return x[..., :half] @ _dequant(lo, s_lo, x.dtype) + x[..., half:] @ _dequant(hi, s_hi, x.dtype)


W8A8_ROUTES = (None, "ops", "rows", "fused")


def _up8(v: int, least: int = 8) -> int:
    return max(least, -(-v // 8) * 8)


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """t (r, c) with zero rows and columns up to (rows, cols); t itself when
    it has them."""
    if t.shape == (rows, cols):
        return t
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def int8_dot(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 x_q (…, K) and int8 w_q (K, N); the JAX
    package leaves this dot to XLA. On the card w_q is K-contiguous, as
    ops.quant stores int8 per-channel weights (cuBLAS's fast int8 layout),
    and torch._int_mm (cuBLASLt) wants more than 16 rows in x_q and K, N
    multiples of 8, so the operands are padded with zero rows and columns
    (exact)."""
    *lead, k = x_q.shape
    n = w_q.shape[1]
    a = x_q.reshape(-1, k)
    m = a.shape[0]
    if a.device.type != "cuda":
        return torch._int_mm(a.contiguous(), w_q).reshape(*lead, n)
    if not is_k_major(w_q):
        raise ValueError(f"int8 weights on the card are K-contiguous (strides (1, {k}), as ops.quant "
                         f"stores them), got strides {w_q.stride()}")
    kp = _up8(k)
    w_q = _pad_to(w_q.t(), _up8(n), kp).t()  # stays K-contiguous
    y = torch._int_mm(_pad_to(a, _up8(m, 24), kp), w_q)
    return y[:m, :n].reshape(*lead, n)


def _w8a8(p: dict, x: torch.Tensor, route: str) -> torch.Tensor:
    """int8 activations × int8 per-channel weights, the W8A8 branch of the
    JAX package's `dense` (flux_generator_tpu/ops/linear.py:145-191) with
    its FGT_W8A8_IMPL formulations as explicit routes:

      "fused" ↔ "pallas": kernel G, per-(row, K block) scales, f32 until
                the output cast;
      "rows"  ↔ "pq":     kernel H (per-row scales in f32), the int8 dot,
                then acc·sx·scale in x's dtype;
      "ops"   ↔ "xla":    everything in x's dtype: sx = max(amax/127, 1e-8),
                x_q = clip(round(x/sx), ±127), the int8 dot, (acc·sx)·scale.

    "fused" and "rows" take their kernel only for a 2-D kernel with at least
    16 activation rows, "fused" also only for K % 128 == 0; every other case
    takes the "ops" formulation, as the JAX package dispatches."""
    q, scale = p["kernel_q"], p["kernel_scale"]
    if q.dim() != 2:
        raise NotImplementedError("W8A8 takes a 2-D kernel; take the layer first")
    k = x.shape[-1]
    dt = x.dtype
    m_rows = x.numel() // k
    if route == "fused" and m_rows >= 16 and w8a8_kernels.supported(k, scale):
        return w8a8_kernels.w8a8_matmul(x, q, scale)
    if route == "rows" and m_rows >= 16:
        x_q, sx = w8a8_kernels.quantize_rows(x)
        return int8_dot(x_q, q).to(dt) * sx.to(dt) * scale.to(dt)
    # max(sx, 1e-8): the floor rounded to x's dtype, as JAX's weak-typed
    # scalar, since no value of that dtype lies between the two
    sx = (x.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    x_q = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
    return int8_dot(x_q, q).to(dt) * sx * scale.to(dt)


def dense(p: dict, x: torch.Tensor, w8a8: Optional[str] = None) -> torch.Tensor:
    """x (…, in) @ kernel (in, out) [+ (x @ lora_a) @ lora_b] [+ bias], for
    f32/bf16 kernels, int8 weight-only (per channel or grouped) and packed
    int4. Packed int4 takes the int4 kernel (its plain version on CPU
    tensors) where the JAX package takes its TPU kernel, and the two-halves
    formulation elsewhere (`_int4`). The LoRA term (scale 1) applies on every tier.

    `w8a8` ("ops", "rows" or "fused"; see `_w8a8`) sends an int8 kernel with
    per-channel scales through int8 activations; grouped scales and int4
    keep their weight-only paths, as in the JAX package (unpacked int4, held
    as int8, is told by the INT4_MARK leaf beside it)."""
    if w8a8 not in W8A8_ROUTES:
        raise ValueError(f"w8a8 must be one of {W8A8_ROUTES}, got {w8a8!r}")
    if "kernel_q4" in p:
        y = _int4(x, p["kernel_q4"], p["kernel_scale"])
    elif "kernel_q" in p:
        grouped = p["kernel_scale"].dim() == p["kernel_q"].dim()
        if w8a8 and not grouped and p["kernel_q"].dtype == torch.int8 and INT4_MARK not in p:
            y = _w8a8(p, x, w8a8)
        else:
            y = x @ _dequant(p["kernel_q"], p["kernel_scale"], x.dtype)
    else:
        y = x @ p["kernel"].to(x.dtype)
    if "lora_a" in p:
        y = y + (x @ p["lora_a"].to(x.dtype)) @ p["lora_b"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def dense_parallel(p: dict, x: torch.Tensor, tp, role: str, w8a8: Optional[str] = None) -> torch.Tensor:
    """`dense` on this rank's shard of a tensor-parallel module
    (parallel/sharding.TP_PLAN) over the "model" axis of mesh `tp`: "col"
    gives this rank's output slice; "row" sums the ranks' partial products,
    then adds the bias once; "gather" concatenates the ranks' output slices
    in rank order. With tp None, `dense` itself."""
    if tp is None or role == "col":
        return dense(p, x, w8a8)
    if role == "gather":
        return all_gather(dense(p, x, w8a8), tp, MODEL_AXIS, dim=-1)
    if role != "row":
        raise ValueError(f"role must be col, row or gather, got {role!r}")
    if w8a8 and tp.size(MODEL_AXIS) > 1:
        # int8 activations take a row's scale over the whole K, which no rank holds
        raise NotImplementedError("W8A8 on a row-parallel dense: the activation scale spans the split K")
    y = all_reduce(dense({k: v for k, v in p.items() if k != "bias"}, x, w8a8), tp, MODEL_AXIS)
    return y + p["bias"].to(y.dtype) if "bias" in p else y


def conv2d(p: dict, x: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """x: (B, H, W, C) NHWC; kernel (kh, kw, in, out) HWIO → (B, H', W', out).
    `padding` is an int or ((top, bottom), (left, right))."""
    if isinstance(stride, int):
        stride = (stride, stride)
    xc = x.permute(0, 3, 1, 2)
    if isinstance(padding, int):
        pad = padding
    else:
        (t, b), (l, r) = padding
        if t == b and l == r:
            pad = (t, l)
        else:
            xc = F.pad(xc, (l, r, t, b))
            pad = 0
    w = p["kernel"].to(x.dtype).permute(3, 2, 0, 1)
    bias = p["bias"].to(x.dtype) if "bias" in p else None
    y = F.conv2d(xc, w, bias, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def conv1d(p: dict, x: torch.Tensor, stride: int = 1, padding=0, groups: int = 1,
           dilation: int = 1) -> torch.Tensor:
    """x: (B, T, C) NHC; kernel (k, in/groups, out) HIO → (B, T', out).
    `padding` is an int, a (left, right) pair or [(left, right)]."""
    if isinstance(padding, int):
        left = right = padding
    else:
        left, right = padding[0] if isinstance(padding[0], (tuple, list)) else padding
    xc = x.transpose(1, 2)
    if left != right:
        xc = F.pad(xc, (left, right))
        left = 0
    w = p["kernel"].to(x.dtype).permute(2, 1, 0)
    bias = p["bias"].to(x.dtype) if "bias" in p else None
    y = F.conv1d(xc, w, bias, stride=stride, padding=left, dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv_transpose1d(p: dict, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The JAX package's transposed 1-D conv: x (B, T, C) dilated by
    `stride`, padded by k - 1 on both sides and convolved with the HIO
    kernel (k, in, out) as stored → (B, (T - 1)·stride + k, out). That is
    torch's ConvTranspose1d with the kernel flipped in time (checkpoint
    kernels are flipped at load, io/params.t_convtr1d)."""
    w = p["kernel"].to(x.dtype).flip(0).permute(1, 2, 0)  # (in, out, k)
    bias = p["bias"].to(x.dtype) if "bias" in p else None
    return F.conv_transpose1d(x.transpose(1, 2), w, bias, stride=stride).transpose(1, 2)
