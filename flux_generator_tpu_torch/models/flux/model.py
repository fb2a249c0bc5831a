"""Flux MMDiT flow transformer (counterpart of
flux_generator_tpu/models/flux/model.py).

Double-stream blocks over separate image/text tokens, then single-stream
blocks over the concatenated sequence; AdaLN modulation from the timestep
(+ guidance) + pooled-CLIP vector; 3-axis RoPE. The blocks of each kind are
stacked on a leading layer axis, as in the JAX package, and run by a Python
loop where it scans. Attention runs the flash kernel (fused RoPE) on CUDA
tensors and its plain version on CPU tensors. The forward also runs
tensor-parallel, pipeline-parallel and with ring attention
(flux_forward's tp, pp and ring), and recomputes blocks in the backward by
the "block" or "dots" policy.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ...io.params import num_layers, stack_layers, take_layer
from ...ops.embeddings import timestep_embedding
from ...ops.kernels.flash_attention import flash_attention
from ...ops.linear import dense, dense_parallel, init_dense
from ...ops.norms import layer_norm, rms_norm
from ...ops.rope import multi_axis_rope
from ...parallel.mesh import MODEL_AXIS
from ...parallel.pipeline import pipeline_scan
from ...parallel.ring_attention import ring_attention_rope


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
#
# `tp` is a parallel.mesh.Mesh whose "model" axis splits the heads and the
# MLP hidden features (parallel/sharding.TP_PLAN; the JAX package gets the
# same from GSPMD): each rank runs its heads, a row-parallel dense sums the
# ranks' partial products, and the modulations gather their outputs whole.
# With tp None the blocks run the whole model. `ring` = (mesh, axis,
# threshold) sends an attention of length ≥ threshold that divides over the
# axis around the ring (parallel/ring_attention.py).


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _mlp_embedder(p, x, w8a8=None, tp=None):
    h = F.silu(dense_parallel(p["in_layer"], x, tp, "col", w8a8))
    return dense_parallel(p["out_layer"], h, tp, "row", w8a8)


def _modulation(p, vec, n: int, w8a8=None, tp=None):
    """silu(vec) → linear → 3n chunks of (shift, scale, gate)."""
    m = dense_parallel(p, F.silu(vec), tp, "gather", w8a8)[:, None, :]
    return torch.chunk(m, 3 * n, dim=-1)


def _heads(x, head_dim):
    b, l, _ = x.shape
    return x.reshape(b, l, -1, head_dim)


def _attn_qkv(p, x, head_dim, w8a8=None):
    """qkv projection → (q, k, v) each (B, L, H, D) with QK-RMSNorm (this
    rank's heads under tensor parallelism)."""
    q, k, v = torch.chunk(dense(p["qkv"], x, w8a8), 3, dim=-1)
    q = rms_norm(_heads(q, head_dim), p["q_norm"])
    k = rms_norm(_heads(k, head_dim), p["k_norm"])
    return q, k, _heads(v, head_dim).contiguous()


def _attention(q, k, v, cos, sin, attn_int8, ring):
    if ring is not None:
        mesh, axis, threshold = ring
        length = q.shape[1]
        if length >= threshold and length % mesh.size(axis) == 0:
            return ring_attention_rope(q, k, v, cos, sin, mesh, axis)
    return flash_attention(q, k, v, cos=cos, sin=sin, int8=attn_int8)


def _double_block(p, img, txt, vec, cos, sin, cfg: FluxConfig, w8a8=None, attn_int8="", tp=None, ring=None):
    b, l, _ = img.shape
    s = txt.shape[1]
    i_shift, i_scale, i_gate, i_shift2, i_scale2, i_gate2 = _modulation(p["img_mod"], vec, 2, w8a8, tp)
    t_shift, t_scale, t_gate, t_shift2, t_scale2, t_gate2 = _modulation(p["txt_mod"], vec, 2, w8a8, tp)

    img_mod = (1 + i_scale) * layer_norm(img, eps=1e-6) + i_shift
    txt_mod = (1 + t_scale) * layer_norm(txt, eps=1e-6) + t_shift
    iq, ik, iv = _attn_qkv(p["img_attn"], img_mod, cfg.head_dim, w8a8)
    tq, tk, tv = _attn_qkv(p["txt_attn"], txt_mod, cfg.head_dim, w8a8)

    # joint attention over concat(txt, img), the reference order
    q = torch.cat([tq, iq], dim=1)
    k = torch.cat([tk, ik], dim=1)
    v = torch.cat([tv, iv], dim=1)
    attn = _attention(q, k, v, cos, sin, attn_int8, ring).reshape(b, s + l, -1)
    txt_attn, img_attn = attn[:, :s], attn[:, s:]

    def mlp(pm, x_in):
        return dense_parallel(pm["out"], _gelu(dense(pm["in"], x_in, w8a8)), tp, "row", w8a8)

    img = img + i_gate * dense_parallel(p["img_attn"]["proj"], img_attn, tp, "row", w8a8)
    img = img + i_gate2 * mlp(p["img_mlp"], (1 + i_scale2) * layer_norm(img, eps=1e-6) + i_shift2)

    txt = txt + t_gate * dense_parallel(p["txt_attn"]["proj"], txt_attn, tp, "row", w8a8)
    txt = txt + t_gate2 * mlp(p["txt_mlp"], (1 + t_scale2) * layer_norm(txt, eps=1e-6) + t_shift2)
    return img, txt


def _single_block(p, x, vec, cos, sin, cfg: FluxConfig, w8a8=None, attn_int8="", tp=None, ring=None):
    b, l, _ = x.shape
    h = cfg.hidden_size // (1 if tp is None else tp.size(MODEL_AXIS))  # this rank's attention width
    shift, scale, gate = _modulation(p["modulation"], vec, 1, w8a8, tp)
    x_mod = (1 + scale) * layer_norm(x, eps=1e-6) + shift
    proj = dense(p["linear1"], x_mod, w8a8)
    qkv, mlp = proj[..., : 3 * h], proj[..., 3 * h:]
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    q = rms_norm(_heads(q, cfg.head_dim), p["q_norm"])
    k = rms_norm(_heads(k, cfg.head_dim), p["k_norm"])
    v = _heads(v, cfg.head_dim).contiguous()
    attn = _attention(q, k, v, cos, sin, attn_int8, ring).reshape(b, l, h)
    y = dense_parallel(p["linear2"], torch.cat([attn, _gelu(mlp)], dim=-1), tp, "row", w8a8)
    return x + gate * y


# the 2-D products whose outputs the "dots" policy saves: the products with no
# batch dimensions (jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
REMAT_POLICIES = ("block", "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(remat) -> Optional[str]:
    """flux_forward's `remat` as a policy name: None (no recomputation),
    "block" (True means "block") or "dots"; anything else raises."""
    if remat is False or remat is None:
        return None
    policy = "block" if remat is True else remat
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy must be block|dots, got {remat!r}")
    return policy


def _rematted(fn, policy: Optional[str]):
    if policy is None:
        return fn
    # the blocks draw no random numbers, so no RNG state is stashed
    kw = dict(context_fn=partial(create_selective_checkpoint_contexts, _dots_policy)) if policy == "dots" else {}

    def body(*args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return body


def flux_forward(params, cfg: FluxConfig, img, img_ids, txt, txt_ids, timesteps, y,
                 guidance: Optional[torch.Tensor] = None, remat=False,
                 w8a8: Optional[str] = None, attn_int8: str = "", tp=None, pp: Optional[tuple] = None,
                 ring: Optional[tuple] = None):
    """img: (B, L_img, in_channels) packed 2x2 latent patches; txt: (B, L_txt,
    context_in_dim) T5 features; y: (B, vec_in_dim) pooled CLIP; timesteps,
    guidance: (B,). Returns (B, L_img, in_channels).

    remat recomputes each block in the backward pass (torch.utils.checkpoint,
    non-reentrant), as the JAX package's jax.checkpoint per block: "block"
    (or True) recomputes everything, holding one block's activations instead
    of all 19 + 38; "dots" saves the outputs of the 2-D matmuls (aten.mm,
    aten.addmm) and recomputes the rest, the JAX package's
    dots_with_no_batch_dims_saveable policy.

    w8a8 ("ops", "rows" or "fused", see ops.linear.dense) takes every int8
    per-channel dense, embedders and modulations included, through int8
    activations; attn_int8 ("qk" or "full") picks the int8 tier of both
    block kinds' attention. Both are inference only.

    tp (a parallel.mesh.Mesh) runs the blocks and embedders tensor-parallel
    over its "model" axis on this rank's shard of the params
    (parallel/sharding.shard_params). pp = (mesh, axis, microbatches) runs
    both block stacks pipeline-parallel (parallel/pipeline.pipeline_scan).
    ring = (mesh, axis, threshold) runs each attention of length ≥ threshold
    that divides over the axis as ring attention; under tensor parallelism
    the heads are this rank's and complete, so the ring is not taken."""
    dtype = img.dtype
    policy = remat_policy(remat)
    if tp is not None and tp.size(MODEL_AXIS) > 1:
        ring = None
    img = dense(params["img_in"], img, w8a8)
    vec = _mlp_embedder(params["time_in"], timestep_embedding(timesteps, 256), w8a8, tp)
    if cfg.guidance_embed:
        if guidance is None:
            raise ValueError("guidance-distilled model needs a guidance strength")
        vec = vec + _mlp_embedder(params["guidance_in"], timestep_embedding(guidance, 256), w8a8, tp)
    vec = vec + _mlp_embedder(params["vector_in"], y, w8a8, tp)
    txt = dense(params["txt_in"], txt, w8a8)

    ids = torch.cat([txt_ids, img_ids], dim=1)
    cos, sin = multi_axis_rope(ids, list(cfg.axes_dim), float(cfg.theta))
    cos, sin = cos.to(dtype).contiguous(), sin.to(dtype).contiguous()

    dbl_body, sgl_body = _rematted(_double_block, policy), _rematted(_single_block, policy)
    if pp is not None:
        pp_mesh, pp_axis, pp_mb = pp
        img, txt = pipeline_scan(
            lambda c, p, v, co, si: dbl_body(p, c[0], c[1], v, co, si, cfg, w8a8, attn_int8, tp, ring),
            (img, txt), params["double_blocks"], pp_mesh, pp_axis, pp_mb, extras=(vec, cos, sin))
        x = torch.cat([txt, img], dim=1)
        x = pipeline_scan(
            lambda c, p, v, co, si: sgl_body(p, c, v, co, si, cfg, w8a8, attn_int8, tp, ring),
            x, params["single_blocks"], pp_mesh, pp_axis, pp_mb, extras=(vec, cos, sin))
    else:
        blocks = params["double_blocks"]
        for i in range(num_layers(blocks)):
            img, txt = dbl_body(take_layer(blocks, i), img, txt, vec, cos, sin, cfg, w8a8, attn_int8, tp, ring)
        x = torch.cat([txt, img], dim=1)
        blocks = params["single_blocks"]
        for i in range(num_layers(blocks)):
            x = sgl_body(take_layer(blocks, i), x, vec, cos, sin, cfg, w8a8, attn_int8, tp, ring)
    img = x[:, txt.shape[1]:]

    fl = params["final_layer"]
    shift, scale = torch.chunk(dense(fl["adaLN"], F.silu(vec), w8a8), 2, dim=-1)
    img = (1 + scale[:, None]) * layer_norm(img, eps=1e-6) + shift[:, None]
    return dense(fl["linear"], img, w8a8)
