"""Timestep embeddings (counterpart of flux_generator_tpu/ops/embeddings.py)."""

from __future__ import annotations

import math

import torch


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """Sinusoidal embedding, [cos | sin] halves, computed in f32 and cast
    back to t's dtype when t is floating (flux/layers.py:46-57 semantics)."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device) / half * (-math.log(max_period))
    )
    ang = (time_factor * t.float())[..., None] * freqs
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    return emb.to(t.dtype) if t.is_floating_point() else emb


def sinusoidal_positions(offset, length: int, dim: int, max_period: float = 10000.0,
                         device=None) -> torch.Tensor:
    """MusicGen absolute positions starting at `offset`: (length, dim) f32,
    [cos | sin] halves with frequencies exp(-i·log(max_period)/(half-1))
    (musicgen/musicgen.py:186-191). Positions are offset + arange in f32."""
    pos = torch.arange(length, dtype=torch.float32, device=device) + float(offset)
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=device) * (-math.log(max_period) / (half - 1))
    )
    ang = pos[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
