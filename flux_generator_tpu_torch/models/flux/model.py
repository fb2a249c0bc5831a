"""Flux MMDiT flow transformer (counterpart of
flux_generator_tpu/models/flux/model.py).

Double-stream blocks over separate image/text tokens, then single-stream
blocks over the concatenated sequence; AdaLN modulation from the timestep
(+ guidance) + pooled-CLIP vector; 3-axis RoPE. The blocks of each kind are
stacked on a leading layer axis, as in the JAX package, and run by a Python
loop where it scans. Attention runs the flash kernel (fused RoPE) on CUDA
tensors and its plain version on CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...io.params import num_layers, stack_layers, take_layer
from ...ops.embeddings import timestep_embedding
from ...ops.kernels.flash_attention import flash_attention
from ...ops.linear import dense, init_dense
from ...ops.norms import layer_norm, rms_norm
from ...ops.rope import multi_axis_rope


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64
    vec_in_dim: int = 768
    context_in_dim: int = 4096
    hidden_size: int = 3072
    mlp_ratio: float = 4.0
    num_heads: int = 24
    depth: int = 19
    depth_single_blocks: int = 38
    axes_dim: Sequence[int] = (16, 56, 56)
    theta: int = 10000
    qkv_bias: bool = True
    guidance_embed: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    def __post_init__(self):
        if self.hidden_size % self.num_heads:
            raise ValueError("hidden_size must be divisible by num_heads")
        if sum(self.axes_dim) != self.head_dim:
            raise ValueError(f"axes_dim {self.axes_dim} != head dim {self.head_dim}")


def tiny_flux_config(**overrides) -> FluxConfig:
    """A CPU-testable configuration (the JAX package's tiny config)."""
    base = dict(
        in_channels=16,
        vec_in_dim=24,
        context_in_dim=32,
        hidden_size=64,
        mlp_ratio=2.0,
        num_heads=4,
        depth=2,
        depth_single_blocks=2,
        axes_dim=(4, 6, 6),
        qkv_bias=True,
        guidance_embed=False,
    )
    base.update(overrides)
    return FluxConfig(**base)


# ---------------------------------------------------------------- init


def _init_mlp_embedder(g, in_dim, hidden, dtype, device):
    return {
        "in_layer": init_dense(g, in_dim, hidden, dtype=dtype, device=device),
        "out_layer": init_dense(g, hidden, hidden, dtype=dtype, device=device),
    }


def _init_double_block(g, cfg: FluxConfig, dtype, device):
    h, mlp, hd = cfg.hidden_size, cfg.mlp_hidden, cfg.head_dim

    def dense_(i, o, bias=True):
        return init_dense(g, i, o, bias=bias, dtype=dtype, device=device)

    def attn():
        return {
            "qkv": dense_(h, 3 * h, cfg.qkv_bias),
            "q_norm": {"scale": torch.ones((hd,), dtype=dtype, device=device)},
            "k_norm": {"scale": torch.ones((hd,), dtype=dtype, device=device)},
            "proj": dense_(h, h),
        }

    def mlp_p():
        return {"in": dense_(h, mlp), "out": dense_(mlp, h)}

    return {
        "img_mod": dense_(h, 6 * h),
        "txt_mod": dense_(h, 6 * h),
        "img_attn": attn(),
        "txt_attn": attn(),
        "img_mlp": mlp_p(),
        "txt_mlp": mlp_p(),
    }


def _init_single_block(g, cfg: FluxConfig, dtype, device):
    h, mlp, hd = cfg.hidden_size, cfg.mlp_hidden, cfg.head_dim
    return {
        "linear1": init_dense(g, h, 3 * h + mlp, dtype=dtype, device=device),
        "linear2": init_dense(g, h + mlp, h, dtype=dtype, device=device),
        "q_norm": {"scale": torch.ones((hd,), dtype=dtype, device=device)},
        "k_norm": {"scale": torch.ones((hd,), dtype=dtype, device=device)},
        "modulation": init_dense(g, h, 3 * h, dtype=dtype, device=device),
    }


def init_flux(generator: torch.Generator, cfg: FluxConfig, dtype=torch.float32, device=None):
    """Random flow params in the JAX tree layout, drawn from `generator`."""
    h = cfg.hidden_size
    params = {
        "img_in": init_dense(generator, cfg.in_channels, h, dtype=dtype, device=device),
        "txt_in": init_dense(generator, cfg.context_in_dim, h, dtype=dtype, device=device),
        "time_in": _init_mlp_embedder(generator, 256, h, dtype, device),
        "vector_in": _init_mlp_embedder(generator, cfg.vec_in_dim, h, dtype, device),
        "double_blocks": stack_layers(lambda: _init_double_block(generator, cfg, dtype, device),
                                      cfg.depth),
        "single_blocks": stack_layers(lambda: _init_single_block(generator, cfg, dtype, device),
                                      cfg.depth_single_blocks),
        "final_layer": {
            "linear": init_dense(generator, h, cfg.in_channels, dtype=dtype, device=device),
            "adaLN": init_dense(generator, h, 2 * h, dtype=dtype, device=device),
        },
    }
    if cfg.guidance_embed:
        params["guidance_in"] = _init_mlp_embedder(generator, 256, h, dtype, device)
    return params


# ---------------------------------------------------------------- forward


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _mlp_embedder(p, x, w8a8=None):
    return dense(p["out_layer"], F.silu(dense(p["in_layer"], x, w8a8)), w8a8)


def _modulation(p, vec, n: int, w8a8=None):
    """silu(vec) → linear → 3n chunks of (shift, scale, gate)."""
    m = dense(p, F.silu(vec), w8a8)[:, None, :]
    return torch.chunk(m, 3 * n, dim=-1)


def _heads(x, num_heads):
    b, l, _ = x.shape
    return x.reshape(b, l, num_heads, -1)


def _attn_qkv(p, x, num_heads, w8a8=None):
    """qkv projection → (q, k, v) each (B, L, H, D) with QK-RMSNorm."""
    q, k, v = torch.chunk(dense(p["qkv"], x, w8a8), 3, dim=-1)
    q = rms_norm(_heads(q, num_heads), p["q_norm"])
    k = rms_norm(_heads(k, num_heads), p["k_norm"])
    return q, k, _heads(v, num_heads).contiguous()


def _double_block(p, img, txt, vec, cos, sin, cfg: FluxConfig, w8a8=None, attn_int8=""):
    b, l, h = img.shape
    s = txt.shape[1]
    i_shift, i_scale, i_gate, i_shift2, i_scale2, i_gate2 = _modulation(p["img_mod"], vec, 2, w8a8)
    t_shift, t_scale, t_gate, t_shift2, t_scale2, t_gate2 = _modulation(p["txt_mod"], vec, 2, w8a8)

    img_mod = (1 + i_scale) * layer_norm(img, eps=1e-6) + i_shift
    txt_mod = (1 + t_scale) * layer_norm(txt, eps=1e-6) + t_shift
    iq, ik, iv = _attn_qkv(p["img_attn"], img_mod, cfg.num_heads, w8a8)
    tq, tk, tv = _attn_qkv(p["txt_attn"], txt_mod, cfg.num_heads, w8a8)

    # joint attention over concat(txt, img), the reference order
    q = torch.cat([tq, iq], dim=1)
    k = torch.cat([tk, ik], dim=1)
    v = torch.cat([tv, iv], dim=1)
    attn = flash_attention(q, k, v, cos=cos, sin=sin, int8=attn_int8).reshape(b, s + l, h)
    txt_attn, img_attn = attn[:, :s], attn[:, s:]

    def mlp(pm, x_in):
        return dense(pm["out"], _gelu(dense(pm["in"], x_in, w8a8)), w8a8)

    img = img + i_gate * dense(p["img_attn"]["proj"], img_attn, w8a8)
    img = img + i_gate2 * mlp(p["img_mlp"], (1 + i_scale2) * layer_norm(img, eps=1e-6) + i_shift2)

    txt = txt + t_gate * dense(p["txt_attn"]["proj"], txt_attn, w8a8)
    txt = txt + t_gate2 * mlp(p["txt_mlp"], (1 + t_scale2) * layer_norm(txt, eps=1e-6) + t_shift2)
    return img, txt


def _single_block(p, x, vec, cos, sin, cfg: FluxConfig, w8a8=None, attn_int8=""):
    b, l, h = x.shape
    shift, scale, gate = _modulation(p["modulation"], vec, 1, w8a8)
    x_mod = (1 + scale) * layer_norm(x, eps=1e-6) + shift
    proj = dense(p["linear1"], x_mod, w8a8)
    qkv, mlp = proj[..., : 3 * h], proj[..., 3 * h:]
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    q = rms_norm(_heads(q, cfg.num_heads), p["q_norm"])
    k = rms_norm(_heads(k, cfg.num_heads), p["k_norm"])
    v = _heads(v, cfg.num_heads).contiguous()
    attn = flash_attention(q, k, v, cos=cos, sin=sin, int8=attn_int8).reshape(b, l, h)
    y = dense(p["linear2"], torch.cat([attn, _gelu(mlp)], dim=-1), w8a8)
    return x + gate * y


def flux_forward(params, cfg: FluxConfig, img, img_ids, txt, txt_ids, timesteps, y,
                 guidance: Optional[torch.Tensor] = None, remat: bool = False,
                 w8a8: Optional[str] = None, attn_int8: str = ""):
    """img: (B, L_img, in_channels) packed 2x2 latent patches; txt: (B, L_txt,
    context_in_dim) T5 features; y: (B, vec_in_dim) pooled CLIP; timesteps,
    guidance: (B,). Returns (B, L_img, in_channels).

    remat=True recomputes each block in the backward pass
    (torch.utils.checkpoint, non-reentrant), as the JAX package's
    jax.checkpoint per block: training holds one block's activations
    instead of all 19 + 38.

    w8a8 ("ops", "rows" or "fused", see ops.linear.dense) takes every int8
    per-channel dense, embedders and modulations included, through int8
    activations; attn_int8 ("qk" or "full") picks the int8 tier of both
    block kinds' attention. Both are inference only."""
    dtype = img.dtype
    img = dense(params["img_in"], img, w8a8)
    vec = _mlp_embedder(params["time_in"], timestep_embedding(timesteps, 256), w8a8)
    if cfg.guidance_embed:
        if guidance is None:
            raise ValueError("guidance-distilled model needs a guidance strength")
        vec = vec + _mlp_embedder(params["guidance_in"], timestep_embedding(guidance, 256), w8a8)
    vec = vec + _mlp_embedder(params["vector_in"], y, w8a8)
    txt = dense(params["txt_in"], txt, w8a8)

    ids = torch.cat([txt_ids, img_ids], dim=1)
    cos, sin = multi_axis_rope(ids, list(cfg.axes_dim), float(cfg.theta))
    cos, sin = cos.to(dtype).contiguous(), sin.to(dtype).contiguous()

    dbl_body, sgl_body = _double_block, _single_block
    if remat:
        # the blocks draw no random numbers, so no RNG state is stashed
        def dbl_body(*args):
            return checkpoint(_double_block, *args, use_reentrant=False, preserve_rng_state=False)

        def sgl_body(*args):
            return checkpoint(_single_block, *args, use_reentrant=False, preserve_rng_state=False)

    blocks = params["double_blocks"]
    for i in range(num_layers(blocks)):
        img, txt = dbl_body(take_layer(blocks, i), img, txt, vec, cos, sin, cfg, w8a8, attn_int8)
    x = torch.cat([txt, img], dim=1)
    blocks = params["single_blocks"]
    for i in range(num_layers(blocks)):
        x = sgl_body(take_layer(blocks, i), x, vec, cos, sin, cfg, w8a8, attn_int8)
    img = x[:, txt.shape[1]:]

    fl = params["final_layer"]
    shift, scale = torch.chunk(dense(fl["adaLN"], F.silu(vec), w8a8), 2, dim=-1)
    img = (1 + scale[:, None]) * layer_norm(img, eps=1e-6) + shift[:, None]
    return dense(fl["linear"], img, w8a8)
