"""The text encoders both families condition on, in plain f32: the T5 v1.1
encoder (relative-position buckets, scale-free attention, gated-GELU or
ReLU feed-forward, RMSNorm; T5-XXL for Flux, T5-base for MusicGen) and the
CLIP-L text encoder (causal pre-LN layers, quick-GELU, pooled at the first
EOS). Weights are the benchmark's seeded draw (`benchmark/weights.py`),
the tree the program is handed (dense kernels (in, out), layers stacked on
a leading axis), widened a layer at a time."""

from __future__ import annotations

import math

import torch

from .ops import F32, Precision, attention, dense, gelu_tanh, layer, layer_norm, rms_norm


def _buckets(rel, num_buckets: int, max_distance: int):
    """Bidirectional T5 buckets of relative positions (key − query)."""
    num_buckets //= 2
    exact = num_buckets // 2
    out = (rel > 0).long() * num_buckets
    n = rel.abs()
    large = exact + (torch.log(n.clamp(min=1).float() / exact) / math.log(max_distance / exact)
                     * (num_buckets - exact)).long()
    return out + torch.where(n < exact, n, large.clamp(max=num_buckets - 1))


def t5_encode(params, cfg: dict, tokens, prec: Precision = F32):
    """tokens (B, L) → (B, L, d_model) f32."""
    enc = params["encoder"]
    x = params["wte"][tokens].float()
    b, n = tokens.shape
    pos = torch.arange(n, device=tokens.device)
    bkt = _buckets(pos[None, :] - pos[:, None], cfg["relative_attention_num_buckets"],
                   cfg["relative_attention_max_distance"])
    bias = enc["rel_bias"].float()[bkt].permute(2, 0, 1)[None]
    gated = cfg["feed_forward_proj"].startswith("gated")
    act = gelu_tanh if cfg["feed_forward_proj"].endswith("gelu") else torch.relu
    eps = cfg["layer_norm_epsilon"]
    for i in range(cfg["num_layers"]):
        p = layer(enc["layers"], i)
        y = rms_norm(x, p["ln1"], eps)
        a = p["attention"]
        q, k, v = (dense(a[m], y, prec).reshape(b, n, cfg["num_heads"], -1) for m in "qkv")
        x = x + dense(a["o"], attention(q, k, v, bias=bias, scale=1.0).reshape(b, n, -1), prec)
        y = rms_norm(x, p["ln2"], eps)
        d = p["dense"]
        h = act(dense(d["wi_0"], y, prec)) * dense(d["wi_1"], y, prec) if gated else act(dense(d["wi"], y, prec))
        x = x + dense(d["wo"], h, prec)
    return rms_norm(x, enc["ln"], eps)


def clip_pooled(params, cfg: dict, tokens, prec: Precision = F32):
    """tokens (B, N) → the final-LayerNorm state at each row's first EOS
    (the largest id), (B, D) f32."""
    b, n = tokens.shape
    x = (params["token_embedding"][tokens] + params["position_embedding"][:n]).float()
    causal = torch.ones((n, n), dtype=torch.bool, device=tokens.device).tril()[None, None]
    heads = cfg["num_heads"]
    for i in range(cfg["num_layers"]):
        p = layer(params["layers"], i)
        y = layer_norm(x, p["ln1"])
        q, k, v = (dense(p[m], y, prec).reshape(b, n, heads, -1) for m in "qkv")
        x = x + dense(p["o"], attention(q, k, v, mask=causal).reshape(b, n, -1), prec)
        y = layer_norm(x, p["ln2"])
        h = dense(p["fc1"], y, prec)
        x = x + dense(p["fc2"], h * torch.sigmoid(1.702 * h), prec)
    x = layer_norm(x, {k: v.float() for k, v in params["final_ln"].items()})
    return x[torch.arange(b, device=x.device), tokens.argmax(-1)]
