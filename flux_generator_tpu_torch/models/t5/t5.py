"""T5 encoder and decoder (counterpart of
flux_generator_tpu/models/t5/t5.py): relative-position-bias attention with
scale 1.0 and no projection biases, gated or plain feed-forward (tanh GELU,
ReLU or SiLU), RMSNorm pre-norm, and an LM head that is the tied embedding
(the hidden state scaled by d_model^-0.5) or its own dense. Layers are
stacked on a leading axis and run by a loop. The decoder runs whole (causal
self-attention over the tokens given) or step by step on a preallocated KV
cache. Dense layers run the int4 kernel when the tree is int4-packed;
`w8a8` takes an int8 per-channel tree through int8 activations
(ops.linear.dense)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ...io.params import num_layers, stack_layers, take_layer
from ...ops.attention import dot_product_attention
from ...ops.linear import dense, dense_parallel, init_dense, rand_normal
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


def _init_dec_layer(g, cfg: T5Config, dtype, device):
    d = cfg.d_model
    return {
        "ln1": {"scale": torch.ones((d,), dtype=dtype, device=device)},
        "self_attention": _init_attn(g, cfg, dtype, device),
        "ln2": {"scale": torch.ones((d,), dtype=dtype, device=device)},
        "cross_attention": _init_attn(g, cfg, dtype, device),
        "ln3": {"scale": torch.ones((d,), dtype=dtype, device=device)},
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


def init_t5(generator: torch.Generator, cfg: T5Config, dtype=torch.float32, device=None):
    """Random encoder-decoder params: the encoder's, a decoder of
    `num_decoder_layers` (else `num_layers`) layers, and an `lm_head` dense
    unless the embeddings are tied."""
    p = init_t5_encoder(generator, cfg, dtype, device)
    p["decoder"] = {
        "layers": stack_layers(lambda: _init_dec_layer(generator, cfg, dtype, device),
                               cfg.num_decoder_layers or cfg.num_layers),
        "ln": {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)},
        "rel_bias": rand_normal(generator, (cfg.relative_attention_num_buckets, cfg.num_heads),
                                0.02, dtype, device),
    }
    if not cfg.tie_word_embeddings:
        p["lm_head"] = init_dense(generator, cfg.d_model, cfg.vocab_size, bias=False, dtype=dtype, device=device)
    return p


def _attn(p, q_in, kv_in, cfg: T5Config, bias=None, mask=None, w8a8=None, tp=None):
    """Attention over this rank's heads under tensor parallelism (tp, a
    parallel.mesh.Mesh: q, k and v column-split by head, o row-split and
    summed across ranks; the bias table split by head alike)."""
    b, lq, _ = q_in.shape
    lk = kv_in.shape[1]
    d = cfg.d_kv
    q = dense(p["q"], q_in, w8a8).reshape(b, lq, -1, d)
    k = dense(p["k"], kv_in, w8a8).reshape(b, lk, -1, d)
    v = dense(p["v"], kv_in, w8a8).reshape(b, lk, -1, d)
    out = dot_product_attention(q, k, v, bias=bias, mask=mask, scale=1.0)
    return dense_parallel(p["o"], out.reshape(b, lq, -1), tp, "row", w8a8)


_ACTS = {
    "relu": F.relu,
    "gelu": lambda v: F.gelu(v, approximate="tanh"),
    "silu": F.silu,
}


def _dense_act(p, x, cfg: T5Config, w8a8=None, tp=None):
    act = _ACTS[cfg.feed_forward_proj.removeprefix("gated-")]
    if "wi_0" in p:
        x = act(dense(p["wi_0"], x, w8a8)) * dense(p["wi_1"], x, w8a8)
    else:
        x = act(dense(p["wi"], x, w8a8))
    return dense_parallel(p["wo"], x, tp, "row", w8a8)


def t5_encode(params, cfg: T5Config, tokens: torch.Tensor, w8a8=None, tp=None) -> torch.Tensor:
    """tokens (B, L) int → (B, L, d_model) in the params' dtype. With tp (a
    parallel.mesh.Mesh), the encoder runs tensor-parallel over its "model"
    axis on this rank's shard of the params (parallel/sharding)."""
    enc = params["encoder"]
    x = params["wte"][tokens]
    length = tokens.shape[1]
    bias = relative_bias(enc["rel_bias"], cfg, length, length, bidirectional=True).to(x.dtype)
    layers = enc["layers"]
    for i in range(num_layers(layers)):
        p = take_layer(layers, i)
        y = rms_norm(x, p["ln1"], cfg.layer_norm_epsilon)
        x = x + _attn(p["attention"], y, y, cfg, bias=bias, w8a8=w8a8, tp=tp)
        y = rms_norm(x, p["ln2"], cfg.layer_norm_epsilon)
        x = x + _dense_act(p["dense"], y, cfg, w8a8, tp)
    return rms_norm(x, enc["ln"], cfg.layer_norm_epsilon)


def init_decode_cache(cfg: T5Config, batch: int, max_len: int, dtype=torch.float32, device=None):
    """The decoder's KV cache: k and v (layers, batch, max_len, heads, d_kv)
    zeroed, and the number of positions written so far."""
    shape = (cfg.num_decoder_layers or cfg.num_layers, batch, max_len, cfg.num_heads, cfg.d_kv)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "offset": 0}


def t5_decode(params, cfg: T5Config, tokens: torch.Tensor, memory: torch.Tensor, cache=None, w8a8=None):
    """Decoder forward: tokens (B, T), memory (B, S, d) from t5_encode →
    (logits (B, T, vocab), cache).

    Without a cache, causal self-attention over the T tokens, and the cache
    returned is None. With one, the T tokens' keys and values are written at
    cache["offset"] (in place) and attention spans the whole preallocated
    length: the unidirectional relative bias over every key position,
    masked to the positions at or before each query's; the cache comes
    back with its offset advanced by T."""
    dec = params["decoder"]
    x = params["wte"][tokens]
    b, t = tokens.shape
    h = cfg.num_heads
    eps = cfg.layer_norm_epsilon
    layers = dec["layers"]
    if cache is None:
        bias = relative_bias(dec["rel_bias"], cfg, t, t, bidirectional=False).to(x.dtype)
        causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()[None, None]
        for i in range(num_layers(layers)):
            p = take_layer(layers, i)
            y = rms_norm(x, p["ln1"], eps)
            x = x + _attn(p["self_attention"], y, y, cfg, bias=bias, mask=causal, w8a8=w8a8)
            y = rms_norm(x, p["ln2"], eps)
            x = x + _attn(p["cross_attention"], y, memory, cfg, w8a8=w8a8)
            y = rms_norm(x, p["ln3"], eps)
            x = x + _dense_act(p["dense"], y, cfg, w8a8)
    else:
        s_max = cache["k"].shape[2]
        offset = int(cache["offset"])
        if offset + t > s_max:
            raise ValueError(f"the cache holds {s_max} positions; {offset} written and {t} more given")
        ctx = torch.arange(t, device=x.device)[:, None] + offset
        mem_pos = torch.arange(s_max, device=x.device)[None, :]
        buckets = _relative_position_bucket(mem_pos - ctx, False, cfg.relative_attention_num_buckets,
                                            cfg.relative_attention_max_distance)
        bias = dec["rel_bias"][buckets].permute(2, 0, 1)[None].to(x.dtype)
        mask = (mem_pos <= ctx)[None, None]  # causal, and only the positions written so far
        for i in range(num_layers(layers)):
            p = take_layer(layers, i)
            sa = p["self_attention"]
            y = rms_norm(x, p["ln1"], eps)
            q = dense(sa["q"], y, w8a8).reshape(b, t, h, -1)
            cache["k"][i, :, offset:offset + t] = dense(sa["k"], y, w8a8).reshape(b, t, h, -1)
            cache["v"][i, :, offset:offset + t] = dense(sa["v"], y, w8a8).reshape(b, t, h, -1)
            attn = dot_product_attention(q, cache["k"][i], cache["v"][i], bias=bias, mask=mask, scale=1.0)
            x = x + dense(sa["o"], attn.reshape(b, t, -1), w8a8)
            y = rms_norm(x, p["ln2"], eps)
            x = x + _attn(p["cross_attention"], y, memory, cfg, w8a8=w8a8)
            y = rms_norm(x, p["ln3"], eps)
            x = x + _dense_act(p["dense"], y, cfg, w8a8)
        cache["offset"] = offset + t
    x = rms_norm(x, dec["ln"], eps)
    if cfg.tie_word_embeddings:
        logits = (x * cfg.d_model ** -0.5) @ params["wte"].t().to(x.dtype)
    else:
        logits = dense(params["lm_head"], x, w8a8)
    return logits, cache
