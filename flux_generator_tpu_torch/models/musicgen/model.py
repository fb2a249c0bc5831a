"""MusicGen delay-pattern autoregressive decoder (counterpart of
flux_generator_tpu/models/musicgen/model.py).

4-codebook summed embeddings plus sinusoidal positions, a decoder-only
transformer (pre-LN self-attention over a KV cache, cross-attention to the
projected T5 conditioning, exact-GELU FFN), 4 output heads, classifier-free
guidance as a 2n batch of [cond; zeros], top-k sampling, the delay pattern
and its undo.

Two routes run a step, chosen as the JAX package chooses them: the fused step
(all layers in one launch of kernel D, ops/kernels/decode_step.py) when the
decoder weights are packable and ffn = 4h, else the plain layer loop
`decode_step`. The AR loop stays on the device with no host sync per step. It
runs exactly `max_steps` steps and attends over the live cache rows only: the
JAX package's step-count buckets and 256-row cache windows exist to serve
XLA's static shapes, and the steps past `max_steps` never reach the first
`max_steps - K + 1` output columns, so the codes are the same.

Sampling uses an explicit `torch.Generator` (Gumbel-max over the top-k
logits), which cannot replay `jax.random.categorical` streams: the two agree
at top_k = 1, where sampling is an argmax.

The self-attention KV cache is held in the activation dtype ("bf16") or in
float8_e4m3fn ("f8", the JAX package's FGT_MG_KV=f8, an argument here),
which halves the bytes of the window a step reads. The two routes store new
rows as the JAX package's do: the plain loop writes each row into the cache
first and attends to it as stored (`_kv_store`, no clamp: past ±464 a value
becomes the NaN byte), the fused step attends to the row in the compute
dtype and stores it clamped to ±448 (ops/kernels/decode_step.store_kv_rows).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ...io.params import stack_layers, take_layer
from ...ops.attention import dot_product_attention
from ...ops.embeddings import sinusoidal_positions
from ...ops.kernels.decode_step import (PHASE_NAMES, fused_decode_step, pack_decode_weights, packable,
                                        phase_split, to_e4m3)
from ...ops.linear import _dequant, dense, init_dense, rand_normal
from ...ops.norms import layer_norm
from ...runtime.profiling import span


@dataclasses.dataclass(frozen=True)
class MusicGenConfig:
    num_codebooks: int = 4
    codebook_size: int = 2048
    bos_token_id: int = 2048
    hidden_size: int = 1536
    num_attention_heads: int = 24
    num_hidden_layers: int = 48
    ffn_dim: int = 6144
    text_d_model: int = 768  # t5-base for musicgen-medium
    sampling_rate: int = 32000

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def tiny_musicgen_config(**overrides) -> MusicGenConfig:
    base = dict(
        num_codebooks=4,
        codebook_size=16,
        bos_token_id=16,
        hidden_size=32,
        num_attention_heads=4,
        num_hidden_layers=2,
        ffn_dim=64,
        text_d_model=16,
    )
    base.update(overrides)
    return MusicGenConfig(**base)


# ------------------------------------------------------------ init


def _ln(h, dtype, device):
    return {"scale": torch.ones((h,), dtype=dtype, device=device),
            "bias": torch.zeros((h,), dtype=dtype, device=device)}


def _init_layer(g, cfg: MusicGenConfig, dtype, device):
    """q/k/v fused into one (h, 3h) kernel per attention, as the checkpoint
    stores in_proj_weight."""
    h = cfg.hidden_size

    def lin(n_in, n_out):
        return init_dense(g, n_in, n_out, bias=False, dtype=dtype, device=device)

    return {
        "norm1": _ln(h, dtype, device),
        "self_attn": {"qkv": lin(h, 3 * h), "o": lin(h, h)},
        "norm_cross": _ln(h, dtype, device),
        "cross_attn": {"qkv": lin(h, 3 * h), "o": lin(h, h)},
        "norm2": _ln(h, dtype, device),
        "linear1": lin(h, cfg.ffn_dim),
        "linear2": lin(cfg.ffn_dim, h),
    }


def init_musicgen(generator: torch.Generator, cfg: MusicGenConfig, dtype=torch.float32, device=None):
    """Random decoder params in the JAX tree layout (layers stacked on a
    leading axis), drawn from `generator`."""
    h = cfg.hidden_size
    return {
        "emb": rand_normal(generator, (cfg.num_codebooks, cfg.codebook_size + 1, h), 0.02, dtype, device),
        "layers": stack_layers(lambda: _init_layer(generator, cfg, dtype, device), cfg.num_hidden_layers),
        "out_norm": _ln(h, dtype, device),
        "linears": rand_normal(generator, (cfg.num_codebooks, h, cfg.codebook_size), 0.02, dtype, device),
        "text_proj": init_dense(generator, cfg.text_d_model, h, dtype=dtype, device=device),
    }


# ------------------------------------------------------------ forward


def _heads(x, n):
    b, t, _ = x.shape
    return x.reshape(b, t, n, -1)


def _materialize(p: dict, dtype) -> torch.Tensor:
    """The (…, in, out) kernel in `dtype`, dequantized if needed."""
    if "kernel_q" in p:
        return _dequant(p["kernel_q"], p["kernel_scale"], dtype)
    return p["kernel"].to(dtype)


def condition_text(params, t5_features, w8a8=None):
    """Project T5 encoder output into the decoder width."""
    return dense(params["text_proj"], t5_features, w8a8)


def precompute_cross_kv(params, cfg: MusicGenConfig, conditioning):
    """Cross-attention K/V of every layer for the fixed conditioning (B, S,
    H), computed once before the loop → two (L, B, S, heads, head_dim)."""
    h = cfg.hidden_size
    qkv = params["layers"]["cross_attn"]["qkv"]
    ks, vs = [], []
    for li in range(cfg.num_hidden_layers):
        kern = _materialize(take_layer(qkv, li), conditioning.dtype)
        ks.append(_heads(conditioning @ kern[:, h:2 * h], cfg.num_attention_heads))
        vs.append(_heads(conditioning @ kern[:, 2 * h:], cfg.num_attention_heads))
    return torch.stack(ks), torch.stack(vs)


KV_DTYPES = ("bf16", "f8")


def kv_cache_dtype(kv_dtype: str, activation_dtype):
    """Storage dtype of the self-attention KV cache: the activation dtype for
    "bf16", float8_e4m3fn for "f8" (the JAX package holds the same bytes in
    int8 buffers, models/musicgen/model.py:146-160)."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
    return torch.float8_e4m3fn if kv_dtype == "f8" else activation_dtype


def _kv_load(x, dtype):
    """Widen a cache slice to the compute dtype (exact from e4m3)."""
    return x.to(dtype)


def _kv_store(x, cache_dtype):
    """Round new K/V rows to the cache's storage type; e4m3 as the JAX
    `_kv_store` does it, with no clamp (ops/kernels/decode_step.to_e4m3)."""
    if cache_dtype == torch.float8_e4m3fn:
        return to_e4m3(x)
    return x.to(cache_dtype)


def init_kv_cache(cfg: MusicGenConfig, batch: int, max_steps: int, dtype, device=None):
    """Zeroed (L, B, max_steps, heads, head_dim) K and V caches in `dtype`
    (kv_cache_dtype: the activation dtype or float8_e4m3fn)."""
    shape = (cfg.num_hidden_layers, batch, max_steps, cfg.num_attention_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _embed_tokens(params, cfg: MusicGenConfig, tokens, offset: int):
    """Summed codebook embeddings + the sinusoidal position of `offset`:
    tokens (B, 1, K) → (B, 1, H)."""
    emb = params["emb"]
    x = torch.stack([emb[k][tokens[..., k]] for k in range(cfg.num_codebooks)]).sum(0)
    pos = sinusoidal_positions(offset, 1, cfg.hidden_size, device=x.device)
    return x + pos[None].to(x.dtype)


def _logits(params, x):
    x = layer_norm(x, params["out_norm"])
    return torch.einsum("btd,kdv->btvk", x, params["linears"].to(x.dtype))


def decode_step(params, cfg: MusicGenConfig, tokens, cross_kv, k_cache, v_cache, offset: int,
                cond_len=None, w8a8=None):
    """One AR step as a plain layer loop. tokens (B, 1, K); caches (L, B,
    S_max, heads, head_dim), written in place at row `offset`; cond_len an
    optional (B,) tensor masking text positions ≥ cond_len[b]. Self-attention
    reads rows 0..offset only. `w8a8` takes the dense projections (not the
    cross-attention's q, which reads its kernel dequantized) through int8
    activations, as the JAX package's `dense` does under set_w8a8. Returns
    (logits (B, 1, V, K), k_cache, v_cache)."""
    nh = cfg.num_attention_heads
    hid = cfg.hidden_size
    x = _embed_tokens(params, cfg, tokens, offset)
    dtype = x.dtype
    cross_k, cross_v = cross_kv
    cross_mask = None
    if cond_len is not None:
        s_text = cross_k.shape[2]
        cross_mask = (torch.arange(s_text, device=x.device)[None, :]
                      < cond_len.to(x.device)[:, None])[:, None, None, :]
    b = x.shape[0]
    for li in range(cfg.num_hidden_layers):
        p = take_layer(params["layers"], li)
        y = layer_norm(x, p["norm1"])
        qkv = dense(p["self_attn"]["qkv"], y, w8a8)
        q = _heads(qkv[..., :hid], nh)
        k_cache[li, :, offset] = _kv_store(_heads(qkv[..., hid:2 * hid], nh)[:, 0], k_cache.dtype)
        v_cache[li, :, offset] = _kv_store(_heads(qkv[..., 2 * hid:], nh)[:, 0], v_cache.dtype)
        kc = _kv_load(k_cache[li, :, :offset + 1], dtype)
        vc = _kv_load(v_cache[li, :, :offset + 1], dtype)
        attn = dot_product_attention(q, kc, vc)
        x = x + dense(p["self_attn"]["o"], attn.reshape(b, 1, -1), w8a8)

        y = layer_norm(x, p["norm_cross"])
        q = _heads(y @ _materialize(p["cross_attn"]["qkv"], y.dtype)[:, :hid], nh)
        attn = dot_product_attention(q, cross_k[li], cross_v[li], mask=cross_mask)
        x = x + dense(p["cross_attn"]["o"], attn.reshape(b, 1, -1), w8a8)

        y = layer_norm(x, p["norm2"])
        x = x + dense(p["linear2"], F.gelu(dense(p["linear1"], y, w8a8), approximate="none"), w8a8)
    return _logits(params, x), k_cache, v_cache


def decode_step_fused(packed, params, cfg: MusicGenConfig, tokens, cross_kv, k_cache, v_cache,
                      offset: int, cond_len=None, timers=None):
    """decode_step through the fused step (kernel D on CUDA tensors, its
    plain version on CPU ones). cross_kv: (ck, cv) each (L, B, S, H) with
    heads flattened; caches (L, B, W, H), written in place at `offset`;
    `timers` an optional row for D's phase stamps (CUDA only)."""
    x = _embed_tokens(params, cfg, tokens, offset)
    ck, cv = cross_kv
    y, k_cache, v_cache = fused_decode_step(packed, x[:, 0, :], ck, cv, offset, k_cache, v_cache,
                                            cond_len, n_heads=cfg.num_attention_heads, timers=timers)
    return _logits(params, y[:, None, :]), k_cache, v_cache


def _stamped(stamps, n_layers: int) -> dict:
    """D's stamps of a loop (steps, 7·L + 1) → its phases' ms summed over
    the layers and steps (`d_phase_ms`), and each step's stamped ms
    (`d_step_ms`): small tensors on the stamps' device, queued there with no
    synchronize, so the stamps themselves are freed."""
    ms = phase_split(stamps, n_layers) / 1e3
    return {"d_phase_ms": dict(zip(PHASE_NAMES, ms.sum(0).unbind())), "d_step_ms": ms.sum(1)}


def top_k_sample(generator, logits, top_k: int, temperature: float):
    """logits (…, V, K) → (…, K) ids: keep the logits at or above the k-th
    largest, then draw from their softmax by Gumbel-max with noise from
    `generator` (no host sync). `generator` is one torch.Generator, or a
    sequence of them, one per leading row of `logits`."""
    lg = logits.transpose(-1, -2).float() / max(float(temperature), 1e-6)  # (…, K, V)
    thresh = torch.topk(lg, top_k, dim=-1).values[..., -1:]
    masked = torch.where(lg >= thresh, lg, float("-inf"))
    if isinstance(generator, torch.Generator):
        u = torch.rand(masked.shape, generator=generator, device=masked.device)
    else:
        u = torch.stack([torch.rand(masked.shape[1:], generator=g, device=masked.device)
                         for g in generator])
    return torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)


def generate(params, cfg: MusicGenConfig, conditioning, max_steps: int = 200, top_k: int = 250,
             temperature: float = 1.0, guidance_coef: float = 3.0,
             generator: Optional[torch.Generator] = None, live_steps=None, cond_len=None,
             generators: Optional[Sequence[torch.Generator]] = None, kv_dtype: str = "bf16",
             step_events: Optional[list] = None, w8a8: Optional[str] = None):
    """Delay-pattern codes for conditioning (n, S, H), n samples in one
    batched loop of exactly `max_steps` steps. Returns codes (n, K,
    max_steps - K + 1), delay undone.

    live_steps: an int or an (n,) tensor of requested step counts; codebook
    k is live during steps [k, live_steps - K + k] and BOS elsewhere.
    cond_len: optional (n,) conditioning lengths; cross-attention masks text
    positions ≥ cond_len[i] for sample i and its unconditional twin.
    generators: optional n generators, one sampling stream per sample (the
    JAX package's per-sample `keys`); they replace `generator`.
    kv_dtype: "bf16" (the activation dtype) or "f8" (e4m3 caches, the JAX
    package's FGT_MG_KV=f8), on either route.
    step_events: optional list (CUDA only) that receives a timing event
    recorded before the loop and one after each step.
    w8a8: a W8A8 route of the plain layer loop's projections (decode_step);
    the fused step reads its weights itself, as the JAX package's Pallas
    step does, so the route does not change it."""
    device = conditioning.device
    K = cfg.num_codebooks
    n = conditioning.shape[0]
    if generators is not None:
        if len(generators) != n:
            raise ValueError(f"{len(generators)} generators for {n} samples")
        generator = list(generators)
    elif generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = conditioning.dtype
    kv_dt = kv_cache_dtype(kv_dtype, dtype)
    if live_steps is None:
        live_steps = max_steps
    live_n = torch.as_tensor(live_steps, device=device).reshape(-1).expand(n)

    cond = torch.cat([conditioning, torch.zeros_like(conditioning)], dim=0)  # CFG: [cond; uncond]
    with span("fgt.musicgen.cross_kv", device):
        cross_kv = precompute_cross_kv(params, cfg, cond)
    cl2 = None
    if cond_len is not None:
        cl = torch.as_tensor(cond_len, dtype=torch.int32, device=device).reshape(n)
        cl2 = torch.cat([cl, cl])

    fused = cfg.ffn_dim == 4 * cfg.hidden_size and packable(params["layers"])
    L, B2, H = cfg.num_hidden_layers, 2 * n, cfg.hidden_size
    if fused:
        with span("fgt.musicgen.repack", device):
            packed = pack_decode_weights(params["layers"], H, cfg.ffn_dim)
        ckv = tuple(a.reshape(L, B2, a.shape[2], H) for a in cross_kv)
        k_cache = torch.zeros((L, B2, max_steps, H), dtype=kv_dt, device=device)
        v_cache = torch.zeros_like(k_cache)
    else:
        k_cache, v_cache = init_kv_cache(cfg, B2, max_steps, kv_dt, device)

    seq = torch.full((n, max_steps + 1, K), cfg.bos_token_id, dtype=torch.int64, device=device)
    ks = torch.arange(K, device=device)

    def mark():
        if step_events is not None:
            step_events.append(torch.cuda.Event(enable_timing=True))
            step_events[-1].record()

    with span("fgt.musicgen.ar", device) as ar:
        stamps = None
        if ar is not None and fused and device.type == "cuda":
            # D's phase stamps, a row a step, reduced on the device as the loop ends
            stamps = torch.zeros((max_steps, len(PHASE_NAMES) * L + 1), dtype=torch.int64, device=device)
        mark()
        for offset in range(max_steps):
            tok = seq[:, offset:offset + 1]
            tok2 = torch.cat([tok, tok], dim=0)
            if fused:
                logits, k_cache, v_cache = decode_step_fused(
                    packed, params, cfg, tok2, ckv, k_cache, v_cache, offset, cond_len=cl2,
                    timers=None if stamps is None else stamps[offset])
            else:
                logits, k_cache, v_cache = decode_step(params, cfg, tok2, cross_kv, k_cache, v_cache,
                                                       offset, cond_len=cl2, w8a8=w8a8)
            cond_l, uncond_l = logits[:n, 0], logits[n:, 0]  # (n, V, K)
            mixed = uncond_l + (cond_l - uncond_l) * guidance_coef
            sampled = top_k_sample(generator, mixed, top_k, temperature)  # (n, K)
            live = (offset >= ks[None]) & (offset <= live_n[:, None] - K + ks[None])
            seq[:, offset + 1] = torch.where(live, sampled, cfg.bos_token_id)
            mark()
        if stamps is not None:
            ar.attrs.update(_stamped(stamps, L))

    t_out = max_steps - K + 1  # undo the delay: codebook k shifted back by k
    return torch.stack([seq[:, k + 1:k + 1 + t_out, k] for k in range(K)], dim=1)
