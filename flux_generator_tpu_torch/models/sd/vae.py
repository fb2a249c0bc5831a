"""SD VAE with a 4-channel latent (counterpart of
flux_generator_tpu/models/sd/vae.py), NHWC over the JAX package's tree.

Resnet stacks per level, a single-head mid attention (one head of the
deepest width, 512 at full size: plain attention, as in the JAX package),
stride-2 downsampling after a (0, 1) pad, nearest 2x upsampling, the
quant / post-quant 1x1 projections as dense layers, and the scaling factor
folded into encode and decode.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...ops.attention import dot_product_attention
from ...ops.linear import conv2d, dense, init_conv2d, init_dense
from ...ops.norms import group_norm
from .config import AutoencoderConfig
from .unet import _init_gn, _init_resnet, _resnet, _upsample_nearest


def _init_attn(g, dims, dtype, device):
    return {"group_norm": _init_gn(dims, dtype, device),
            **{n: init_dense(g, dims, dims, dtype=dtype, device=device) for n in ("q", "k", "v", "o")}}


def _attn(p, x, groups):
    b, h, w, c = x.shape
    y = group_norm(x, p["group_norm"], groups).reshape(b, h * w, c)
    q = dense(p["q"], y)[:, :, None, :]
    k = dense(p["k"], y)[:, :, None, :]
    v = dense(p["v"], y)[:, :, None, :]
    y = dot_product_attention(q, k, v).reshape(b, h * w, c)
    return x + dense(p["o"], y).reshape(b, h, w, c)


def _init_block(g, cin, cout, n_layers, down, up, dtype, device):
    p = {"resnets": [_init_resnet(g, cin if i == 0 else cout, cout, None, dtype, device)
                     for i in range(n_layers)]}
    if down:
        p["downsample"] = init_conv2d(g, cout, cout, 3, dtype=dtype, device=device)
    if up:
        p["upsample"] = init_conv2d(g, cout, cout, 3, dtype=dtype, device=device)
    return p


def _block(p, x, groups):
    for res in p["resnets"]:
        x = _resnet(res, x, None, groups)
    if "downsample" in p:
        # one row and one column of zeros after, none before
        x = conv2d(p["downsample"], x, stride=2, padding=((0, 1), (0, 1)))
    if "upsample" in p:
        x = conv2d(p["upsample"], _upsample_nearest(x), padding=1)
    return x


def init_sd_vae(generator: torch.Generator, cfg: AutoencoderConfig, dtype=torch.float32, device=None):
    """Random params in the JAX tree layout, drawn from `generator`."""
    g = generator
    boc = list(cfg.block_out_channels)
    n = len(boc)

    def mid():
        return [_init_resnet(g, boc[-1], boc[-1], None, dtype, device), _init_attn(g, boc[-1], dtype, device),
                _init_resnet(g, boc[-1], boc[-1], None, dtype, device)]

    enc = {"conv_in": init_conv2d(g, cfg.in_channels, boc[0], 3, dtype=dtype, device=device)}
    chans = [boc[0]] + boc
    enc["down_blocks"] = [_init_block(g, ic, oc, cfg.layers_per_block, i < n - 1, False, dtype, device)
                          for i, (ic, oc) in enumerate(zip(chans, chans[1:]))]
    enc["mid_blocks"] = mid()
    enc["conv_norm_out"] = _init_gn(boc[-1], dtype, device)
    enc["conv_out"] = init_conv2d(g, boc[-1], cfg.latent_channels_out, 3, dtype=dtype, device=device)

    # the decoder's levels hold layers_per_block + 1 resnets
    dec = {"conv_in": init_conv2d(g, cfg.latent_channels_in, boc[-1], 3, dtype=dtype, device=device)}
    dec["mid_blocks"] = mid()
    rev = list(reversed(boc))
    chans = [rev[0]] + rev
    dec["up_blocks"] = [_init_block(g, ic, oc, cfg.layers_per_block + 1, False, i < n - 1, dtype, device)
                        for i, (ic, oc) in enumerate(zip(chans, chans[1:]))]
    dec["conv_norm_out"] = _init_gn(boc[0], dtype, device)
    dec["conv_out"] = init_conv2d(g, boc[0], cfg.out_channels, 3, dtype=dtype, device=device)
    return {
        "encoder": enc,
        "decoder": dec,
        "quant_proj": init_dense(g, cfg.latent_channels_out, cfg.latent_channels_out, dtype=dtype, device=device),
        "post_quant_proj": init_dense(g, cfg.latent_channels_in, cfg.latent_channels_in, dtype=dtype,
                                      device=device),
    }


def sd_vae_encode(params, cfg: AutoencoderConfig, x):
    """Images (B, H, W, 3) → (mean, logvar) of the latent, scaling folded in."""
    g = cfg.norm_num_groups
    enc = params["encoder"]
    h = conv2d(enc["conv_in"], x, padding=1)
    for blk in enc["down_blocks"]:
        h = _block(blk, h, g)
    h = _resnet(enc["mid_blocks"][0], h, None, g)
    h = _attn(enc["mid_blocks"][1], h, g)
    h = _resnet(enc["mid_blocks"][2], h, None, g)
    h = F.silu(group_norm(h, enc["conv_norm_out"], g))
    h = conv2d(enc["conv_out"], h, padding=1)
    h = dense(params["quant_proj"], h)
    mean, logvar = torch.chunk(h, 2, dim=-1)
    return mean * cfg.scaling_factor, logvar + 2 * math.log(cfg.scaling_factor)


def sd_vae_decode(params, cfg: AutoencoderConfig, z):
    """Latents (B, h, w, 4) → images (B, h·f, w·f, 3), about [-1, 1]."""
    g = cfg.norm_num_groups
    z = z / cfg.scaling_factor
    dec = params["decoder"]
    h = conv2d(dec["conv_in"], dense(params["post_quant_proj"], z), padding=1)
    h = _resnet(dec["mid_blocks"][0], h, None, g)
    h = _attn(dec["mid_blocks"][1], h, g)
    h = _resnet(dec["mid_blocks"][2], h, None, g)
    for blk in dec["up_blocks"]:
        h = _block(blk, h, g)
    h = F.silu(group_norm(h, dec["conv_norm_out"], g))
    return conv2d(dec["conv_out"], h, padding=1)
