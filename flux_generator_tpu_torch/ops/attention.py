"""Scaled dot-product attention, plain torch (counterpart of
flux_generator_tpu/ops/attention.py). T5, CLIP and the VAE use it, as the
JAX package leaves theirs to XLA; the Flux blocks use the flash kernel
(ops/kernels/flash_attention.py), whose tests compare against this.

Layout: q, k, v are (B, L, H, D).
"""

from __future__ import annotations

import torch


def dot_product_attention(q, k, v, mask=None, bias=None, scale=None):
    """q: (B, Lq, H, D), k/v: (B, Lk, H, D). mask: broadcastable to
    (B, H, Lq, Lk), True = attend; bias is added to the logits (T5 relative
    bias). Logits and softmax in f32; probabilities are cast to v's dtype
    before the PV product. Returns (B, Lq, H, D) in v's dtype."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)
