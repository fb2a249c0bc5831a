"""Flux VAE (16-channel latent conv autoencoder) (counterpart of
flux_generator_tpu/models/flux/autoencoder.py).

ResnetBlocks (GroupNorm32 + SiLU + 3x3 conv, linear nin_shortcut on a
channel change), a single-head mid attention block, stride-2 downsampling
after a (0, 1) pad and nearest 2x upsampling, and the scale/shift factors
applied in `encode` / `decode`, and the overlap-tiled decode for large
latents. Activations are NHWC and conv kernels HWIO, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from ...ops.attention import dot_product_attention
from ...ops.linear import conv2d, dense, init_conv2d, init_dense
from ...ops.norms import group_norm
from ...ops.tiling import tiled_decode_2d


@dataclasses.dataclass(frozen=True)
class AutoEncoderConfig:
    resolution: int = 256
    in_channels: int = 3
    ch: int = 128
    out_ch: int = 3
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 16
    scale_factor: float = 0.3611
    shift_factor: float = 0.1159


def tiny_ae_config(**overrides) -> AutoEncoderConfig:
    base = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4)
    base.update(overrides)
    return AutoEncoderConfig(**base)


# ---------------------------------------------------------------- init


def _init_gn(ch, dtype, device):
    return {"scale": torch.ones((ch,), dtype=dtype, device=device),
            "bias": torch.zeros((ch,), dtype=dtype, device=device)}


def _init_resnet(g, cin, cout, dtype, device):
    p = {
        "norm1": _init_gn(cin, dtype, device),
        "conv1": init_conv2d(g, cin, cout, 3, dtype=dtype, device=device),
        "norm2": _init_gn(cout, dtype, device),
        "conv2": init_conv2d(g, cout, cout, 3, dtype=dtype, device=device),
    }
    if cin != cout:
        p["nin_shortcut"] = init_dense(g, cin, cout, dtype=dtype, device=device)
    return p


def _init_attn(g, ch, dtype, device):
    return {
        "norm": _init_gn(ch, dtype, device),
        **{n: init_dense(g, ch, ch, dtype=dtype, device=device) for n in ("q", "k", "v", "proj_out")},
    }


def _init_encoder(g, cfg: AutoEncoderConfig, dtype, device):
    nres = len(cfg.ch_mult)
    p = {"conv_in": init_conv2d(g, cfg.in_channels, cfg.ch, 3, dtype=dtype, device=device)}
    in_mult = (1,) + tuple(cfg.ch_mult)
    down = []
    block_in = cfg.ch
    for i in range(nres):
        block_in = cfg.ch * in_mult[i]
        block_out = cfg.ch * cfg.ch_mult[i]
        blocks = []
        for _ in range(cfg.num_res_blocks):
            blocks.append(_init_resnet(g, block_in, block_out, dtype, device))
            block_in = block_out
        lvl = {"block": blocks}
        if i != nres - 1:
            lvl["downsample"] = init_conv2d(g, block_in, block_in, 3, dtype=dtype, device=device)
        down.append(lvl)
    p["down"] = down
    p["mid"] = {
        "block_1": _init_resnet(g, block_in, block_in, dtype, device),
        "attn_1": _init_attn(g, block_in, dtype, device),
        "block_2": _init_resnet(g, block_in, block_in, dtype, device),
    }
    p["norm_out"] = _init_gn(block_in, dtype, device)
    p["conv_out"] = init_conv2d(g, block_in, 2 * cfg.z_channels, 3, dtype=dtype, device=device)
    return p


def _init_decoder(g, cfg: AutoEncoderConfig, dtype, device):
    nres = len(cfg.ch_mult)
    block_in = cfg.ch * cfg.ch_mult[nres - 1]
    p = {"conv_in": init_conv2d(g, cfg.z_channels, block_in, 3, dtype=dtype, device=device)}
    p["mid"] = {
        "block_1": _init_resnet(g, block_in, block_in, dtype, device),
        "attn_1": _init_attn(g, block_in, dtype, device),
        "block_2": _init_resnet(g, block_in, block_in, dtype, device),
    }
    up = [None] * nres
    for i in reversed(range(nres)):
        block_out = cfg.ch * cfg.ch_mult[i]
        blocks = []
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(_init_resnet(g, block_in, block_out, dtype, device))
            block_in = block_out
        lvl = {"block": blocks}
        if i != 0:
            lvl["upsample"] = init_conv2d(g, block_in, block_in, 3, dtype=dtype, device=device)
        up[i] = lvl
    p["up"] = up
    p["norm_out"] = _init_gn(block_in, dtype, device)
    p["conv_out"] = init_conv2d(g, block_in, cfg.out_ch, 3, dtype=dtype, device=device)
    return p


def init_autoencoder(generator: torch.Generator, cfg: AutoEncoderConfig, dtype=torch.float32,
                     device=None):
    return {"encoder": _init_encoder(generator, cfg, dtype, device),
            "decoder": _init_decoder(generator, cfg, dtype, device)}


# ---------------------------------------------------------------- forward


def _groups(c: int) -> int:
    return 32 if c >= 32 else c


def _resnet(p, x):
    h = F.silu(group_norm(x, p["norm1"], _groups(x.shape[-1]), eps=1e-6))
    h = conv2d(p["conv1"], h, padding=1)
    h = F.silu(group_norm(h, p["norm2"], _groups(h.shape[-1]), eps=1e-6))
    h = conv2d(p["conv2"], h, padding=1)
    if "nin_shortcut" in p:
        x = dense(p["nin_shortcut"], x)
    return x + h


def _attn_block(p, x):
    b, hh, ww, c = x.shape
    y = group_norm(x.reshape(b, hh * ww, c), p["norm"], _groups(c), eps=1e-6)
    q = dense(p["q"], y)[:, :, None, :]
    k = dense(p["k"], y)[:, :, None, :]
    v = dense(p["v"], y)[:, :, None, :]
    y = dot_product_attention(q, k, v).reshape(b, hh * ww, c)
    y = dense(p["proj_out"], y)
    return x + y.reshape(b, hh, ww, c)


def encoder_forward(p, cfg: AutoEncoderConfig, x):
    h = conv2d(p["conv_in"], x, padding=1)
    for lvl in p["down"]:
        for blk in lvl["block"]:
            h = _resnet(blk, h)
        if "downsample" in lvl:
            # asymmetric pad: one row and one column after, none before
            h = conv2d(lvl["downsample"], h, stride=2, padding=((0, 1), (0, 1)))
    h = _resnet(p["mid"]["block_1"], h)
    h = _attn_block(p["mid"]["attn_1"], h)
    h = _resnet(p["mid"]["block_2"], h)
    h = F.silu(group_norm(h, p["norm_out"], _groups(h.shape[-1]), eps=1e-6))
    return conv2d(p["conv_out"], h, padding=1)


def encode(params, cfg: AutoEncoderConfig, x, generator=None):
    """Image (B, H, W, 3) in about [-1, 1] → latent (B, H/8, W/8, z). The
    mean, unless a generator is given for the reparameterized sample."""
    moments = encoder_forward(params["encoder"], cfg, x)
    mean, logvar = torch.chunk(moments, 2, dim=-1)
    z = mean
    if generator is not None:
        eps = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=torch.float32)
        z = mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)
    return cfg.scale_factor * (z - cfg.shift_factor)


def decoder_forward(p, cfg: AutoEncoderConfig, z):
    h = conv2d(p["conv_in"], z, padding=1)
    h = _resnet(p["mid"]["block_1"], h)
    h = _attn_block(p["mid"]["attn_1"], h)
    h = _resnet(p["mid"]["block_2"], h)
    for i in reversed(range(len(p["up"]))):
        lvl = p["up"][i]
        for blk in lvl["block"]:
            h = _resnet(blk, h)
        if "upsample" in lvl:
            h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            h = conv2d(lvl["upsample"], h, padding=1)
    h = F.silu(group_norm(h, p["norm_out"], _groups(h.shape[-1]), eps=1e-6))
    return conv2d(p["conv_out"], h, padding=1)


def decode(params, cfg: AutoEncoderConfig, z):
    """Latent (B, h, w, z) → image (B, 8h, 8w, 3) in about [-1, 1]."""
    z = z / cfg.scale_factor + cfg.shift_factor
    return decoder_forward(params["decoder"], cfg, z)


def downsample(cfg: AutoEncoderConfig) -> int:
    """Spatial factor between image and latent (8 at full size)."""
    return 2 ** (len(cfg.ch_mult) - 1)


def decode_tiled(params, cfg: AutoEncoderConfig, z, tile: int = 96, overlap: int = 16):
    """Decode a large latent in overlapping tiles with a linear cross-fade
    (ops/tiling.tiled_decode_2d): the decoder's activations are those of one
    tile of `tile`² latent pixels, whatever the latent's size."""
    return tiled_decode_2d(lambda zt: decode(params, cfg, zt), z, tile, overlap, factor=downsample(cfg))
