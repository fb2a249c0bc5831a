"""T5 encoder (counterpart of the encoder half of
flux_generator_tpu/models/t5/t5.py): relative-position-bias attention with
scale 1.0 and no projection biases, gated-gelu feed-forward (tanh GELU),
RMSNorm pre-norm. Layers are stacked on a leading axis and run by a loop.
Its dense layers run the int4 kernel when the tree is int4-packed; `w8a8`
takes an int8 per-channel tree through int8 activations (ops.linear.dense)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ...io.params import num_layers, stack_layers, take_layer
from ...ops.attention import dot_product_attention
from ...ops.linear import dense, init_dense, rand_normal
from ...ops.norms import rms_norm


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    d_kv: int = 64
    d_model: int = 4096
    feed_forward_proj: str = "gated-gelu"
    tie_word_embeddings: bool = False
    d_ff: Optional[int] = 10240
    num_decoder_layers: Optional[int] = None
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


def tiny_t5_config(**overrides) -> T5Config:
    base = dict(
        vocab_size=64,
        num_layers=2,
        num_heads=2,
        relative_attention_num_buckets=8,
        d_kv=8,
        d_model=16,
        feed_forward_proj="gated-gelu",
        tie_word_embeddings=True,
        d_ff=32,
        num_decoder_layers=2,
        relative_attention_max_distance=16,
    )
    base.update(overrides)
    return T5Config(**base)


def _relative_position_bucket(rpos, bidirectional: bool, num_buckets: int, max_distance: int):
    """T5 log-binned relative positions."""
    if bidirectional:
        num_buckets = num_buckets // 2
    max_exact = num_buckets // 2
    abspos = rpos.abs()
    is_small = abspos < max_exact
    scale = (num_buckets - max_exact) / math.log(max_distance / max_exact)
    large = (torch.log(abspos.clamp(min=1).float() / max_exact) * scale).to(torch.int64)
    large = torch.clamp(max_exact + large, max=num_buckets - 1)
    buckets = torch.where(is_small, abspos, large)
    if bidirectional:
        buckets = buckets + (rpos > 0).to(buckets.dtype) * num_buckets
    else:
        buckets = buckets * (rpos < 0).to(buckets.dtype)
    return buckets


def relative_bias(embeddings, cfg: T5Config, query_length: int, key_length: int,
                  offset: int = 0, bidirectional: bool = True):
    """embeddings: (num_buckets, num_heads) → bias (1, heads, q, k)."""
    device = embeddings.device
    ctx = torch.arange(query_length, device=device)[:, None] + offset
    mem = torch.arange(key_length, device=device)[None, :]
    buckets = _relative_position_bucket(
        mem - ctx, bidirectional, cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance,
    )
    return embeddings[buckets].permute(2, 0, 1)[None]


def _init_attn(g, cfg: T5Config, dtype, device):
    inner = cfg.d_kv * cfg.num_heads
    d = cfg.d_model
    return {
        "q": init_dense(g, d, inner, bias=False, dtype=dtype, device=device),
        "k": init_dense(g, d, inner, bias=False, dtype=dtype, device=device),
        "v": init_dense(g, d, inner, bias=False, dtype=dtype, device=device),
        "o": init_dense(g, inner, d, bias=False, dtype=dtype, device=device),
    }


def _init_dense_act(g, cfg: T5Config, dtype, device):
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.feed_forward_proj.startswith("gated"):
        return {
            "wi_0": init_dense(g, d, ff, bias=False, dtype=dtype, device=device),
            "wi_1": init_dense(g, d, ff, bias=False, dtype=dtype, device=device),
            "wo": init_dense(g, ff, d, bias=False, dtype=dtype, device=device),
        }
    return {
        "wi": init_dense(g, d, ff, bias=False, dtype=dtype, device=device),
        "wo": init_dense(g, ff, d, bias=False, dtype=dtype, device=device),
    }


def _init_enc_layer(g, cfg: T5Config, dtype, device):
    d = cfg.d_model
    return {
        "ln1": {"scale": torch.ones((d,), dtype=dtype, device=device)},
        "attention": _init_attn(g, cfg, dtype, device),
        "ln2": {"scale": torch.ones((d,), dtype=dtype, device=device)},
        "dense": _init_dense_act(g, cfg, dtype, device),
    }


def init_t5_encoder(generator: torch.Generator, cfg: T5Config, dtype=torch.float32, device=None):
    """Random encoder params in the JAX tree layout, drawn from `generator`."""
    return {
        "wte": rand_normal(generator, (cfg.vocab_size, cfg.d_model), 0.02, dtype, device),
        "encoder": {
            "layers": stack_layers(lambda: _init_enc_layer(generator, cfg, dtype, device),
                                   cfg.num_layers),
            "ln": {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)},
            "rel_bias": rand_normal(generator, (cfg.relative_attention_num_buckets, cfg.num_heads),
                                0.02, dtype, device),
        },
    }


def _attn(p, q_in, kv_in, cfg: T5Config, bias=None, mask=None, w8a8=None):
    b, lq, _ = q_in.shape
    lk = kv_in.shape[1]
    h = cfg.num_heads
    q = dense(p["q"], q_in, w8a8).reshape(b, lq, h, -1)
    k = dense(p["k"], kv_in, w8a8).reshape(b, lk, h, -1)
    v = dense(p["v"], kv_in, w8a8).reshape(b, lk, h, -1)
    out = dot_product_attention(q, k, v, bias=bias, mask=mask, scale=1.0)
    return dense(p["o"], out.reshape(b, lq, -1), w8a8)


_ACTS = {
    "relu": F.relu,
    "gelu": lambda v: F.gelu(v, approximate="tanh"),
    "silu": F.silu,
}


def _dense_act(p, x, cfg: T5Config, w8a8=None):
    act = _ACTS[cfg.feed_forward_proj.removeprefix("gated-")]
    if "wi_0" in p:
        x = act(dense(p["wi_0"], x, w8a8)) * dense(p["wi_1"], x, w8a8)
    else:
        x = act(dense(p["wi"], x, w8a8))
    return dense(p["wo"], x, w8a8)


def t5_encode(params, cfg: T5Config, tokens: torch.Tensor, w8a8=None) -> torch.Tensor:
    """tokens (B, L) int → (B, L, d_model) in the params' dtype."""
    enc = params["encoder"]
    x = params["wte"][tokens]
    length = tokens.shape[1]
    bias = relative_bias(enc["rel_bias"], cfg, length, length, bidirectional=True).to(x.dtype)
    layers = enc["layers"]
    for i in range(num_layers(layers)):
        p = take_layer(layers, i)
        y = rms_norm(x, p["ln1"], cfg.layer_norm_epsilon)
        x = x + _attn(p["attention"], y, y, cfg, bias=bias, w8a8=w8a8)
        y = rms_norm(x, p["ln2"], cfg.layer_norm_epsilon)
        x = x + _dense_act(p["dense"], y, cfg, w8a8)
    return rms_norm(x, enc["ln"], cfg.layer_norm_epsilon)
