"""Normalization ops (counterpart of flux_generator_tpu/ops/norms.py).
Statistics accumulate in float32 whatever the activation dtype, then the
result is cast back."""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, p=None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis. p may hold optional 'scale'/'bias'."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = ((xf - mean) * torch.reciprocal(torch.sqrt(var + eps))).to(x.dtype)
    if p is not None:
        if "scale" in p:
            y = y * p["scale"].to(x.dtype)
        if "bias" in p:
            y = y + p["bias"].to(x.dtype)
    return y


def rms_norm(x: torch.Tensor, p=None, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis (T5 / QK-norm style: no mean subtraction)."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = (xf * torch.reciprocal(torch.sqrt(ms + eps))).to(x.dtype)
    if p is not None and "scale" in p:
        y = y * p["scale"].to(x.dtype)
    return y


def group_norm(x: torch.Tensor, p=None, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over channel-last activations (B, ..., C).

    One-pass E[x²] − E[x]² statistics on input shifted by each group's first
    element, as in the JAX package: the shift is constant over the
    reduction, so the variance is unchanged, and the cancellation is relative
    to the group's spread rather than its magnitude (|mean| ≫ std stays
    exact)."""
    shape = x.shape
    c = shape[-1]
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    xf = x.float().reshape(shape[0], -1, groups, c // groups)
    xs = xf - xf[:, :1, :, :1]
    mean_s = xs.mean(dim=(1, 3), keepdim=True)
    m2_s = (xs * xs).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(m2_s - mean_s * mean_s, min=0.0)
    y = ((xs - mean_s) * torch.reciprocal(torch.sqrt(var + eps))).reshape(shape).to(x.dtype)
    if p is not None:
        if "scale" in p:
            y = y * p["scale"].to(x.dtype)
        if "bias" in p:
            y = y + p["bias"].to(x.dtype)
    return y
