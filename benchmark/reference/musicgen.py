"""MusicGen text-to-music in plain f32 (MusicGen's published design): T5
conditioning projected to the decoder width, the delay-pattern decoder
(four summed codebook embeddings plus sinusoidal positions, pre-LN causal
self-attention, cross-attention to the text, exact-GELU feed-forward, four
output heads) under classifier-free guidance, and the EnCodec 32 kHz
decoder (residual codebooks summed, SEANet with its two-layer LSTM,
reflect-padded convs, transposed convs).

The decoder runs teacher-forced: it is handed the codes the program served,
lays them out in the delay pattern itself, and gives the guided logits at
every position in one causal pass, with no cache. Weights are the seeded
tensors the benchmark drew and handed to the program, widened a layer at a
time.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .ops import F32, Precision, attention, conv1d, conv_transpose1d, dense, layer, layer_norm
from .text import t5_encode


def conditioning(weights, cfg: dict, t5_tokenizer, prompt: str, prec: Precision = F32):
    """prompt → projected T5 features (1, S, hidden) f32."""
    device = weights["decoder"]["emb"].device
    tokens = torch.tensor([t5_tokenizer.encode(prompt, pad=False)], device=device)
    return dense(weights["decoder"]["text_proj"], t5_encode(weights["t5"], cfg["t5"], tokens, prec), prec)


def delayed(codes, cfg: dict, steps: int):
    """Served codes (n, K, steps − K + 1) → the decoder's inputs (n, steps, K):
    BOS at position 0, then codebook k's code t − k at position t + 1 while
    k ≤ t ≤ steps − K + k, BOS elsewhere."""
    n, kb, _ = codes.shape
    seq = torch.full((n, steps + 1, kb), cfg["bos_token_id"], dtype=torch.long, device=codes.device)
    for k in range(kb):
        seq[:, k + 1:steps - kb + k + 2, k] = codes[:, k]
    return seq


def live_mask(cfg: dict, steps: int, device):
    """(steps, K) True where codebook k samples at step t."""
    t = torch.arange(steps, device=device)[:, None]
    k = torch.arange(cfg["num_codebooks"], device=device)[None]
    return (t >= k) & (t <= steps - cfg["num_codebooks"] + k)


def guided_logits(weights, cfg: dict, cond, seq, guidance: float, prec: Precision = F32):
    """cond (n, S, H) (the rows' conditioning, unpadded: all rows share S),
    seq (n, T + 1, K) → the guided logits uncond + g·(cond − uncond) at each
    of the T steps, (n, T, V, K) f32. The unconditional twin's text is zeros."""
    p0 = weights["decoder"]
    n, kb = seq.shape[0], cfg["num_codebooks"]
    h, heads, steps = cfg["hidden_size"], cfg["num_attention_heads"], seq.shape[1] - 1
    tok = torch.cat([seq[:, :steps], seq[:, :steps]])
    x = sum(p0["emb"][k].float()[tok[..., k]] for k in range(kb))
    pos = torch.arange(steps, dtype=torch.float32, device=x.device)
    half = h // 2
    ang = pos[:, None] * torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                                   * (-math.log(10000.0) / (half - 1)))[None]
    x = x + torch.cat([torch.cos(ang), torch.sin(ang)], -1)[None]
    text = torch.cat([cond.float(), torch.zeros_like(cond, dtype=torch.float32)])
    causal = torch.ones((steps, steps), dtype=torch.bool, device=x.device).tril()[None, None]
    for i in range(cfg["num_hidden_layers"]):
        p = layer(p0["layers"], i)
        y = layer_norm(x, p["norm1"])
        q, k, v = (t.reshape(2 * n, steps, heads, -1) for t in dense(p["self_attn"]["qkv"], y, prec).chunk(3, -1))
        x = x + dense(p["self_attn"]["o"], attention(q, k, v, mask=causal).flatten(2), prec)
        y = layer_norm(x, p["norm_cross"])
        wq, wk, wv = p["cross_attn"]["qkv"]["kernel"].chunk(3, dim=-1)
        q = (prec.act(y) @ prec.weight(wq)).reshape(2 * n, steps, heads, -1)
        k = (prec.act(text) @ prec.weight(wk)).reshape(2 * n, text.shape[1], heads, -1)
        v = (prec.act(text) @ prec.weight(wv)).reshape(2 * n, text.shape[1], heads, -1)
        x = x + dense(p["cross_attn"]["o"], attention(q, k, v).flatten(2), prec)
        y = layer_norm(x, p["norm2"])
        x = x + dense(p["linear2"], F.gelu(dense(p["linear1"], y, prec)), prec)
        del p
    x = layer_norm(x, p0["out_norm"])
    logits = torch.einsum("btd,kdv->btvk", prec.act(x), prec.weight(p0["linears"], -1))
    return logits[n:] + (logits[:n] - logits[n:]) * guidance


# ------------------------------------------------------------ EnCodec decoder


def _pad_conv(p, cfg, x, k, stride, dilation, prec):
    """SEANet's non-causal conv: reflect padding of the effective kernel
    (k − 1)·dilation + 1 less the stride, split with the extra frames on the
    right, as EnCodec pads."""
    eff = (k - 1) * dilation + 1
    total = eff - stride
    frames = math.ceil((x.shape[1] - eff + total) / stride + 1) - 1
    extra = frames * stride + eff - total - x.shape[1]
    right = total // 2
    x = F.pad(x.transpose(1, 2), (total - right, right + extra), mode="reflect").transpose(1, 2)
    return conv1d(p["conv"], x, prec, stride, dilation)


def _lstm(p, x, prec):
    """One LSTM layer over (B, T, D), gates (i, f, g, o), f32 states."""
    xw = dense({"kernel": p["wx"], "bias": p["bias"]}, x, prec)
    wh = prec.weight(p["wh"])
    h = torch.zeros(x.shape[0], wh.shape[0], device=x.device)
    c = torch.zeros_like(h)
    out = []
    for t in range(x.shape[1]):
        i, f, g, o = (xw[:, t] + prec.act(h) @ wh).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=1)


def encodec_decode(params, cfg: dict, codes, prec: Precision = F32):
    """codes (B, nq, T) → waveform (B, T·hop, channels) f32."""
    x = sum(params["quantizer"][i]["embed"].float()[codes[:, i]] for i in range(codes.shape[1]))
    layers = iter(params["decoder"])
    ratios = cfg["upsampling_ratios"]
    x = _pad_conv(next(layers), cfg, x, cfg["kernel_size"], 1, 1, prec)
    lstm = next(layers)["lstm"]
    h = x
    for lp in lstm:
        h = _lstm(lp, h, prec)
    x = x + h
    for ratio in ratios:
        next(layers)  # ELU
        x = F.elu(x)
        p = next(layers)
        y = conv_transpose1d(p["conv"], x, prec, ratio)
        right = (2 * ratio - ratio) // 2
        x = y[:, 2 * ratio - ratio - right:y.shape[1] - right]
        for j in range(cfg["num_residual_layers"]):
            blk = next(layers)["block"]
            y = _pad_conv(blk[0], cfg, F.elu(x), cfg["residual_kernel_size"], 1, cfg["dilation_growth_rate"] ** j,
                          prec)
            x = x + _pad_conv(blk[1], cfg, F.elu(y), 1, 1, 1, prec)
    next(layers)  # ELU
    return _pad_conv(next(layers), cfg, F.elu(x), cfg["last_kernel_size"], 1, 1, prec)
