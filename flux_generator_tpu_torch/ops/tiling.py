"""Overlap-tiled spatial decode and per-image batching (counterpart of
flux_generator_tpu/ops/tiling.py).

A VAE decoder at 2048² holds gigabytes of conv activations per layer.
`tiled_decode_2d` runs the decoder once per overlapping tile and cross-fades
the overlaps with linear ramps; dividing by the summed weights makes pixels
with a single contributor (the image borders) exact. PyTorch runs eagerly, so
the JAX package's `lax.scan` over the tiles becomes a Python loop that blends
each tile into the output as soon as it is decoded: one tile's activations
are alive at a time, and the f32 output is updated in place.
"""

from __future__ import annotations

from typing import Callable

import torch


def _scaled(v: int, factor) -> int:
    s = v * factor
    if abs(s - round(s)) >= 1e-9:
        raise ValueError(f"tile geometry {v} · {factor} is not integral")
    return int(round(s))


def _axis_ramp(n: int, overlap: int, device) -> torch.Tensor:
    """Up-ramp over `overlap` pixels, flat middle, down-ramp (f32)."""
    r = torch.clamp(torch.arange(n, dtype=torch.float32, device=device) + 1.0, max=float(overlap)) / overlap
    return torch.minimum(r, r.flip(0))


def tiled_decode_2d(decode_fn: Callable, z: torch.Tensor, tile: int, overlap: int, factor):
    """decode_fn: (B, t, t, C) tile → (B, t·factor, t·factor, out). z: (B, H,
    W, C). Returns the blended (B, H·factor, W·factor, out) result in z's
    dtype. `factor` may be fractional (1/8 for a VAE encoder mapping image
    tiles to latent tiles) as long as the tile, the overlap and every tile
    offset scale to integers. One plain call when z fits one tile.

    Tile positions, ramps and blending are the JAX package's: per-axis tiles
    clamped to the input, offsets stepping by tile − overlap and clamped to
    the last full tile (a sorted set), f32 sums of tile·weight and of the
    weights, then the division by max(weights, 1e-6)."""
    b, h, w, _ = z.shape
    if h <= tile and w <= tile:
        return decode_fn(z)
    tile_h, tile_w = min(tile, h), min(tile, w)
    stride_h = max(tile_h - overlap, 1)
    stride_w = max(tile_w - overlap, 1)
    ys = sorted({max(0, min(y, h - tile_h)) for y in range(0, h, stride_h)})
    xs = sorted({max(0, min(x, w - tile_w)) for x in range(0, w, stride_w)})
    tf_h, tf_w, of = _scaled(tile_h, factor), _scaled(tile_w, factor), _scaled(overlap, factor)
    out_h, out_w = _scaled(h, factor), _scaled(w, factor)

    wt = (_axis_ramp(tf_h, of, z.device)[:, None] * _axis_ramp(tf_w, of, z.device)[None, :])[..., None]
    out = wsum = None
    for y in ys:
        for x in xs:
            img = decode_fn(z[:, y:y + tile_h, x:x + tile_w])
            if out is None:
                out = torch.zeros((b, out_h, out_w, img.shape[-1]), dtype=torch.float32, device=z.device)
                wsum = torch.zeros((out_h, out_w, 1), dtype=torch.float32, device=z.device)
            y0, x0 = _scaled(y, factor), _scaled(x, factor)
            out[:, y0:y0 + tf_h, x0:x0 + tf_w] += img.float() * wt
            wsum[y0:y0 + tf_h, x0:x0 + tf_w] += wt
            del img
    return (out / torch.clamp(wsum, min=1e-6)).to(z.dtype)


def batched_apply(fn: Callable, z: torch.Tensor, pixel_limit: int):
    """fn (itself possibly tiled) over a batch, one image at a time when the
    batch's B·H·W exceeds `pixel_limit`: the decoder has no cross-batch op, so
    the result equals the batched call, with one image's activations alive."""
    b, h, w = z.shape[:3]
    if b <= 1 or b * h * w <= pixel_limit:
        return fn(z)
    return torch.cat([fn(zi[None]) for zi in z])
