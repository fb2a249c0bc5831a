"""Functional dense / conv primitives over plain-dict params (counterpart of
flux_generator_tpu/ops/linear.py).

Layouts are the JAX package's, kept at every public function: dense kernels
are (in_features, out_features), convs take NHWC activations and HWIO
kernels. `conv2d` transposes to torch's NCHW/OIHW inside; an NHWC tensor
permuted to NCHW is torch's channels_last layout, so cuDNN runs it without a
copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels.int4_matmul import int4_matmul


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


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (…, in) @ kernel (in, out) [+ (x @ lora_a) @ lora_b] [+ bias], for
    f32/bf16 kernels, int8 weight-only (per channel or grouped) and packed
    int4. Packed int4 runs the int4 kernel on CUDA tensors and its plain
    version on CPU ones. The LoRA term (scale 1) applies on every tier."""
    if "kernel_q4" in p:
        y = int4_matmul(x, p["kernel_q4"], p["kernel_scale"])
    elif "kernel_q" in p:
        y = x @ _dequant(p["kernel_q"], p["kernel_scale"], x.dtype)
    else:
        y = x @ p["kernel"].to(x.dtype)
    if "lora_a" in p:
        y = y + (x @ p["lora_a"].to(x.dtype)) @ p["lora_b"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


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
