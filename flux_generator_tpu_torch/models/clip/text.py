"""CLIP text encoder (counterpart of flux_generator_tpu/models/clip/text.py):
causal-mask pre-LN transformer with quick_gelu (or exact gelu), final
LayerNorm at the default eps, pooled output at the EOS position found by
argmax over the token ids, and every layer's output (SDXL conditions on the
second to last). Layers are stacked and run by a loop."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ...io.params import num_layers, stack_layers, take_layer
from ...ops.attention import dot_product_attention
from ...ops.linear import dense, init_dense, rand_normal
from ...ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    num_layers: int = 23
    model_dims: int = 1024
    num_heads: int = 16
    max_length: int = 77
    vocab_size: int = 49408
    hidden_act: str = "quick_gelu"  # or "gelu"
    projection_dim: int | None = None  # SDXL encoder-2 text_projection


def tiny_clip_config(**overrides) -> CLIPTextConfig:
    base = dict(num_layers=2, model_dims=32, num_heads=4, max_length=16, vocab_size=64)
    base.update(overrides)
    return CLIPTextConfig(**base)


def _act(name):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    return lambda x: F.gelu(x)


def _init_layer(g, cfg: CLIPTextConfig, dtype, device):
    d = cfg.model_dims

    def ln():
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}

    return {
        "ln1": ln(),
        "ln2": ln(),
        "q": init_dense(g, d, d, dtype=dtype, device=device),
        "k": init_dense(g, d, d, dtype=dtype, device=device),
        "v": init_dense(g, d, d, dtype=dtype, device=device),
        "o": init_dense(g, d, d, dtype=dtype, device=device),
        "fc1": init_dense(g, d, 4 * d, dtype=dtype, device=device),
        "fc2": init_dense(g, 4 * d, d, dtype=dtype, device=device),
    }


def init_clip_text(generator: torch.Generator, cfg: CLIPTextConfig, dtype=torch.float32,
                   device=None):
    """Random params in the JAX tree layout, drawn from `generator`."""
    d = cfg.model_dims
    p = {
        "token_embedding": rand_normal(generator, (cfg.vocab_size, d), 0.02, dtype, device),
        "position_embedding": rand_normal(generator, (cfg.max_length, d), 0.02, dtype, device),
        "layers": stack_layers(lambda: _init_layer(generator, cfg, dtype, device), cfg.num_layers),
        "final_ln": {"scale": torch.ones((d,), dtype=dtype, device=device),
                     "bias": torch.zeros((d,), dtype=dtype, device=device)},
    }
    if cfg.projection_dim:
        p["text_projection"] = init_dense(generator, d, cfg.projection_dim, bias=False,
                                          dtype=dtype, device=device)
    return p


def _layer(p, x, mask, cfg: CLIPTextConfig, act, w8a8=None):
    b, n, d = x.shape
    y = layer_norm(x, p["ln1"])
    q = dense(p["q"], y, w8a8).reshape(b, n, cfg.num_heads, -1)
    k = dense(p["k"], y, w8a8).reshape(b, n, cfg.num_heads, -1)
    v = dense(p["v"], y, w8a8).reshape(b, n, cfg.num_heads, -1)
    attn = dot_product_attention(q, k, v, mask=mask).reshape(b, n, d)
    x = x + dense(p["o"], attn, w8a8)
    y = layer_norm(x, p["ln2"])
    return x + dense(p["fc2"], act(dense(p["fc1"], y, w8a8)), w8a8)


def clip_text_forward(params, cfg: CLIPTextConfig, tokens: torch.Tensor, w8a8=None) -> dict:
    """tokens (B, N) int → {"last_hidden_state": (B, N, D), "pooled_output":
    (B, D or projection_dim), "hidden_states": a list of num_layers (B, N, D),
    each layer's output before the final LayerNorm}. `w8a8` takes an int8
    per-channel tree through int8 activations (ops.linear.dense)."""
    b, n = tokens.shape
    eos = torch.argmax(tokens, dim=-1)
    x = params["token_embedding"][tokens] + params["position_embedding"][:n]
    causal = torch.tril(torch.ones((n, n), dtype=torch.bool, device=tokens.device))[None, None]
    act = _act(cfg.hidden_act)
    layers = params["layers"]
    hidden = []
    for i in range(num_layers(layers)):
        x = _layer(take_layer(layers, i), x, causal, cfg, act, w8a8)
        hidden.append(x)
    x = layer_norm(x, params["final_ln"])
    pooled = x[torch.arange(b, device=x.device), eos]
    if "text_projection" in params:
        pooled = dense(params["text_projection"], pooled, w8a8)
    return {"last_hidden_state": x, "pooled_output": pooled, "hidden_states": hidden}
