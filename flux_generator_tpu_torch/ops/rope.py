"""Rotary position embeddings, Flux convention (counterpart of
flux_generator_tpu/ops/rope.py): separate cos/sin tables, rotating
INTERLEAVED feature pairs (2i, 2i+1) — not halves:
    out[2i] = x[2i]·cos − x[2i+1]·sin ;  out[2i+1] = x[2i]·sin + x[2i+1]·cos
"""

from __future__ import annotations

import torch


def rope_cos_sin(pos: torch.Tensor, dim: int, theta: float = 10000.0):
    """pos: (..., L) positions → (cos, sin), each (..., L, dim//2) f32."""
    scale = torch.arange(0, dim, 2, dtype=torch.float32, device=pos.device) / dim
    omega = 1.0 / (theta ** scale)
    ang = pos.float()[..., None] * omega
    return torch.cos(ang), torch.sin(ang)


def multi_axis_rope(ids: torch.Tensor, axes_dim, theta: float = 10000.0):
    """Flux EmbedND: ids (B, L, n_axes) → (cos, sin), each
    (B, L, sum(axes_dim)//2), per-axis tables concatenated."""
    parts = [rope_cos_sin(ids[..., i], axes_dim[i], theta) for i in range(ids.shape[-1])]
    cos = torch.cat([c for c, _ in parts], dim=-1)
    sin = torch.cat([s for _, s in parts], dim=-1)
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, L, H, D), rotated along D; cos/sin (B, L, D//2) broadcast over
    heads. Computes in x's dtype, as the JAX function does."""
    shape = x.shape
    xp = x.reshape(*shape[:-1], shape[-1] // 2, 2)
    e, o = xp[..., 0], xp[..., 1]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.stack([e * c - o * s, e * s + o * c], dim=-1).reshape(shape)
