"""Conditional 2-D UNet of SD 2.1 / SDXL (counterpart of
flux_generator_tpu/models/sd/unet.py), NHWC activations over the JAX
package's param tree.

Sinusoidal timesteps (cos first), SDXL's optional `text_time` added
embedding, ResnetBlock2D with the time embedding injected, Transformer2D
sites of cross-attention blocks with a GEGLU feed-forward, and down / up
blocks with skip concatenation. A site's transformer blocks stay stacked on a
leading axis, as the JAX tree stacks them for its `lax.scan`, and a loop runs
them. Self-attention takes kernel A where the JAX package sends it to its
Pallas kernel (`_self_attention`); cross-attention and the shorter
self-attention sequences take the plain attention, as there.

`w8a8` (a route of ops.linear.dense) and `attn_int8` ("", "qk" or "full",
kernel A's int8 tiers) are the JAX package's process-wide `set_w8a8` and
`set_attn_int8`, passed down every call: `w8a8` reaches every dense layer,
`attn_int8` every self-attention that takes kernel A (the tier is dropped
past 6144 tokens, as the JAX wrapper drops it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...io.params import num_layers, stack_layers, take_layer
from ...ops.attention import dot_product_attention
from ...ops.embeddings import timestep_embedding
from ...ops.kernels import flash_attention as fa
from ...ops.linear import conv2d, dense, init_conv2d, init_dense
from ...ops.norms import group_norm, layer_norm
from .config import UNetConfig

# self-attention reaches kernel A from this length on, at head dims that are
# multiples of 64 (flux_generator_tpu/models/sd/unet.py:182-191)
FLASH_MIN_LEN = 256


def _upsample_nearest(x, scale: int = 2):
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


# ------------------------------------------------------------ init


def _init_ln(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


_init_gn = _init_ln


def _init_attn(g, dims, memory_dims, dtype, device):
    return {
        "q": init_dense(g, dims, dims, bias=False, dtype=dtype, device=device),
        "k": init_dense(g, memory_dims, dims, bias=False, dtype=dtype, device=device),
        "v": init_dense(g, memory_dims, dims, bias=False, dtype=dtype, device=device),
        "o": init_dense(g, dims, dims, dtype=dtype, device=device),
    }


def _init_transformer_block(g, dims, memory_dims, dtype, device):
    return {
        "norm1": _init_ln(dims, dtype, device),
        "attn1": _init_attn(g, dims, dims, dtype, device),
        "norm2": _init_ln(dims, dtype, device),
        "attn2": _init_attn(g, dims, memory_dims, dtype, device),
        "norm3": _init_ln(dims, dtype, device),
        # GEGLU: linear1 the value path, linear2 the gate path
        "linear1": init_dense(g, dims, 4 * dims, dtype=dtype, device=device),
        "linear2": init_dense(g, dims, 4 * dims, dtype=dtype, device=device),
        "linear3": init_dense(g, 4 * dims, dims, dtype=dtype, device=device),
    }


def _init_transformer2d(g, in_ch, model_dims, encoder_dims, n_blocks, dtype, device):
    return {
        "norm": _init_gn(in_ch, dtype, device),
        "proj_in": init_dense(g, in_ch, model_dims, dtype=dtype, device=device),
        "blocks": stack_layers(lambda: _init_transformer_block(g, model_dims, encoder_dims, dtype, device),
                               n_blocks),
        "proj_out": init_dense(g, model_dims, in_ch, dtype=dtype, device=device),
    }


def _init_resnet(g, cin, cout, temb, dtype, device):
    p = {
        "norm1": _init_gn(cin, dtype, device),
        "conv1": init_conv2d(g, cin, cout, 3, dtype=dtype, device=device),
        "norm2": _init_gn(cout, dtype, device),
        "conv2": init_conv2d(g, cout, cout, 3, dtype=dtype, device=device),
    }
    if temb is not None:
        p["time_emb_proj"] = init_dense(g, temb, cout, dtype=dtype, device=device)
    if cin != cout:
        p["conv_shortcut"] = init_dense(g, cin, cout, dtype=dtype, device=device)
    return p


def _init_unet_block(g, cfg: UNetConfig, i, in_ch, out_ch, prev_out, down, up, cross, dtype, device):
    n_layers = cfg.layers_per_block[i] + (1 if prev_out is not None else 0)
    if prev_out is None:
        in_list = [in_ch] + [out_ch] * (n_layers - 1)
    else:
        in_list = [prev_out] + [out_ch] * (n_layers - 1)
        res_list = [out_ch] * (n_layers - 1) + [in_ch]
        in_list = [a + b for a, b in zip(in_list, res_list)]
    p = {"resnets": [_init_resnet(g, ic, out_ch, cfg.temb_dim, dtype, device) for ic in in_list]}
    if cross:
        p["attentions"] = [
            _init_transformer2d(g, out_ch, out_ch, cfg.cross_attention_dim[i],
                                cfg.transformer_layers_per_block[i], dtype, device)
            for _ in range(n_layers)
        ]
    if down:
        p["downsample"] = init_conv2d(g, out_ch, out_ch, 3, dtype=dtype, device=device)
    if up:
        p["upsample"] = init_conv2d(g, out_ch, out_ch, 3, dtype=dtype, device=device)
    return p


def init_unet(generator: torch.Generator, cfg: UNetConfig, dtype=torch.float32, device=None):
    """Random params in the JAX tree layout, drawn from `generator`."""
    g = generator
    n = len(cfg.block_out_channels)
    c0 = cfg.block_out_channels[0]
    p = {
        "conv_in": init_conv2d(g, cfg.in_channels, c0, cfg.conv_in_kernel, dtype=dtype, device=device),
        "time_embedding": {
            "linear_1": init_dense(g, c0, cfg.temb_dim, dtype=dtype, device=device),
            "linear_2": init_dense(g, cfg.temb_dim, cfg.temb_dim, dtype=dtype, device=device),
        },
    }
    if cfg.addition_embed_type == "text_time":
        p["add_embedding"] = {
            "linear_1": init_dense(g, cfg.projection_class_embeddings_input_dim, cfg.temb_dim, dtype=dtype,
                                   device=device),
            "linear_2": init_dense(g, cfg.temb_dim, cfg.temb_dim, dtype=dtype, device=device),
        }

    chans = [c0] + list(cfg.block_out_channels)
    p["down_blocks"] = [
        _init_unet_block(g, cfg, i, ic, oc, None, down=(i < n - 1), up=False,
                         cross="CrossAttn" in cfg.down_block_types[i], dtype=dtype, device=device)
        for i, (ic, oc) in enumerate(zip(chans, chans[1:]))
    ]
    cl = cfg.block_out_channels[-1]
    p["mid_blocks"] = [
        _init_resnet(g, cl, cl, cfg.temb_dim, dtype, device),
        _init_transformer2d(g, cl, cl, cfg.cross_attention_dim[-1], cfg.transformer_layers_per_block[-1],
                            dtype, device),
        _init_resnet(g, cl, cl, cfg.temb_dim, dtype, device),
    ]
    chans = [c0] + list(cfg.block_out_channels) + [cl]
    p["up_blocks"] = [  # deepest first
        _init_unet_block(g, cfg, i, ic, oc, po, down=False, up=(i > 0),
                         cross="CrossAttn" in cfg.up_block_types[i], dtype=dtype, device=device)
        for i, (ic, oc, po) in reversed(list(enumerate(zip(chans, chans[1:], chans[2:]))))
    ]
    p["conv_norm_out"] = _init_gn(c0, dtype, device)
    p["conv_out"] = init_conv2d(g, c0, cfg.out_channels, cfg.conv_out_kernel, dtype=dtype, device=device)
    return p


# ------------------------------------------------------------ forward


def _self_attention(q, k, v, attn_int8: str = ""):
    """(B, L, H, D) self-attention: kernel A (its plain version on CPU
    tensors) where the JAX package takes its Pallas flash kernel, L ≥ 256
    and D a multiple of 64, in the int8 tier `attn_int8` up to 6144 tokens;
    the plain attention otherwise."""
    if q.shape[1] >= FLASH_MIN_LEN and q.shape[-1] % 64 == 0:
        return fa.flash_attention(q, k, v, int8=attn_int8)
    return dot_product_attention(q, k, v)


def _transformer_block(p, x, memory, num_heads, w8a8=None, attn_int8=""):
    b, l, d = x.shape
    y = layer_norm(x, p["norm1"])
    q = dense(p["attn1"]["q"], y, w8a8).reshape(b, l, num_heads, -1)
    k = dense(p["attn1"]["k"], y, w8a8).reshape(b, l, num_heads, -1)
    v = dense(p["attn1"]["v"], y, w8a8).reshape(b, l, num_heads, -1)
    x = x + dense(p["attn1"]["o"], _self_attention(q, k, v, attn_int8).reshape(b, l, d), w8a8)

    y = layer_norm(x, p["norm2"])
    s = memory.shape[1]
    q = dense(p["attn2"]["q"], y, w8a8).reshape(b, l, num_heads, -1)
    k = dense(p["attn2"]["k"], memory, w8a8).reshape(b, s, num_heads, -1)
    v = dense(p["attn2"]["v"], memory, w8a8).reshape(b, s, num_heads, -1)
    x = x + dense(p["attn2"]["o"], dot_product_attention(q, k, v).reshape(b, l, d), w8a8)

    y = layer_norm(x, p["norm3"])
    y = dense(p["linear1"], y, w8a8) * F.gelu(dense(p["linear2"], y, w8a8))
    return x + dense(p["linear3"], y, w8a8)


def _transformer2d(p, x, memory, num_heads, groups, w8a8=None, attn_int8=""):
    b, h, w, c = x.shape
    # Transformer2D's GroupNorm takes eps 1e-6, the resnets' 1e-5, as the
    # weights' own convention (flux_generator_tpu/models/sd/unet.py:241-250)
    y = group_norm(x, p["norm"], groups, eps=1e-6).reshape(b, h * w, c)
    y = dense(p["proj_in"], y, w8a8)
    blocks = p["blocks"]
    for i in range(num_layers(blocks)):
        y = _transformer_block(take_layer(blocks, i), y, memory, num_heads, w8a8, attn_int8)
    y = dense(p["proj_out"], y, w8a8)
    return x + y.reshape(b, h, w, c)


def _resnet(p, x, temb, groups, w8a8=None):
    y = F.silu(group_norm(x, p["norm1"], groups))
    y = conv2d(p["conv1"], y, padding=1)
    if temb is not None and "time_emb_proj" in p:
        y = y + dense(p["time_emb_proj"], F.silu(temb), w8a8)[:, None, None, :]
    y = F.silu(group_norm(y, p["norm2"], groups))
    y = conv2d(p["conv2"], y, padding=1)
    if "conv_shortcut" in p:
        x = dense(p["conv_shortcut"], x, w8a8)
    return x + y


def _unet_block(p, cfg: UNetConfig, i, x, memory, temb, residuals=None, w8a8=None, attn_int8=""):
    outputs = []
    for j, res in enumerate(p["resnets"]):
        if residuals is not None:
            x = torch.cat([x, residuals.pop()], dim=-1)
        x = _resnet(res, x, temb, cfg.norm_num_groups, w8a8)
        if "attentions" in p:
            x = _transformer2d(p["attentions"][j], x, memory, cfg.num_attention_heads[i], cfg.norm_num_groups,
                               w8a8, attn_int8)
        outputs.append(x)
    if "downsample" in p:
        x = conv2d(p["downsample"], x, stride=2, padding=1)
        outputs.append(x)
    if "upsample" in p:
        x = conv2d(p["upsample"], _upsample_nearest(x), padding=1)
        outputs.append(x)
    return x, outputs


def compute_temb(params, cfg: UNetConfig, timestep, text_time, dtype, w8a8=None):
    """The time embedding, plus SDXL's text_time added embedding when
    `text_time` = (pooled text (B, P), time_ids (B, 6)) is given."""
    temb = timestep_embedding(timestep.float(), cfg.block_out_channels[0], time_factor=1.0).to(dtype)
    te = params["time_embedding"]
    temb = dense(te["linear_2"], F.silu(dense(te["linear_1"], temb, w8a8)), w8a8)
    if text_time is not None:
        text_emb, time_ids = text_time
        add = timestep_embedding(time_ids.float().reshape(-1), cfg.addition_time_embed_dim, time_factor=1.0)
        add = torch.cat([text_emb, add.reshape(time_ids.shape[0], -1).to(dtype)], dim=-1)
        ae = params["add_embedding"]
        temb = temb + dense(ae["linear_2"], F.silu(dense(ae["linear_1"], add, w8a8)), w8a8)
    return temb


def unet_forward(params, cfg: UNetConfig, x, timestep, encoder_x, text_time=None, w8a8=None, attn_int8=""):
    """x (B, H, W, in) latents, timestep (B,), encoder_x (B, S, context) →
    (B, H, W, out); `text_time` as in `compute_temb` (SDXL); `w8a8` and
    `attn_int8` as in the module docstring."""
    temb = compute_temb(params, cfg, timestep, text_time, x.dtype, w8a8)
    x = conv2d(params["conv_in"], x, padding=(cfg.conv_in_kernel - 1) // 2)

    residuals = [x]
    for i, blk in enumerate(params["down_blocks"]):
        x, outs = _unet_block(blk, cfg, i, x, encoder_x, temb, w8a8=w8a8, attn_int8=attn_int8)
        residuals.extend(outs)

    groups = cfg.norm_num_groups
    x = _resnet(params["mid_blocks"][0], x, temb, groups, w8a8)
    x = _transformer2d(params["mid_blocks"][1], x, encoder_x, cfg.num_attention_heads[-1], groups, w8a8, attn_int8)
    x = _resnet(params["mid_blocks"][2], x, temb, groups, w8a8)

    n = len(cfg.block_out_channels)
    for idx, blk in enumerate(params["up_blocks"]):
        x, _ = _unet_block(blk, cfg, n - 1 - idx, x, encoder_x, temb, residuals=residuals, w8a8=w8a8,
                           attn_int8=attn_int8)

    x = F.silu(group_norm(x, params["conv_norm_out"], groups))
    return conv2d(params["conv_out"], x, padding=(cfg.conv_out_kernel - 1) // 2)
