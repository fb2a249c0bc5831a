"""Flash attention with RoPE: CUDA kernels (forward) and plain version,
differentiable through kernels E and F (flash_attention_bwd.py).

The forward kernels replace the TPU kernels `_attn_kernel` / `_flash_kernel`
of flux_generator_tpu/ops/pallas/flash_attention.py. `flash_attention`
dispatches on the tensors' device only: CPU tensors go to
`flash_attention_reference`, CUDA tensors to a kernel, which raises for
shapes, dtypes or layouts it does not take. There is no fallback from one to
the other. Its gradient is `_FlashAttention`, the counterpart of the JAX
package's `_flash_core` custom VJP.

The bf16 mode (`int8=""`) is `bf16_forward`: the RoPE pre-pass
(`rope_rotate`) rotates q and k once, as the JAX wrapper pre-rotates them
past 6144 tokens, and `flash_attention_sm90` (csrc/flash_attention_sm90.cu:
wgmma, a TMA ring) attends over the rotated tensors. The int8 tiers run
csrc/flash_attention.cu in two steps: the quantize pre-pass
(`int8_prepass`: q and k rotated and quantized per row once, and for the
"full" modes V quantized per column, transposed and key-permuted, one or two
launches) and the attention kernel (`int8_attention`: int8 wgmma fed by a
TMA ring, bf16 P·V for "qk"). Its bound is the function's products at the
int8 rate (0.0102 ms for "full" at L 1280, 24 heads of 128), with the L²·H
exponentials at the special-function rate (about 0.010 ms there) beside it.

`int8` selects the int8 tiers of the TPU kernel (`int8_mxu`, the one-shot
path's semantics): "qk" quantizes q and k rows for an int8 Q·Kᵀ, "full" also
p (against the row's final max) and V's columns for an int8 P·V. Like the
JAX wrapper, a sequence longer than the one-shot path's 6144 drops them. A
gradient through a tier is the JAX package's straight-through estimate: the
bf16 backward run on the tier's out and lse.

The backward (`flash_attention_backward`) rotates q and k with the same
pre-pass, runs kernels E and F of flash_attention_bwd.py, and pulls dq and
dk back with the pre-pass at (cos, −sin).

`flash_attention_streamed` is the counterpart of the JAX `_flash_attention_jit`
on its streamed path, where the tiers run at any length: "" and "qk" are A's
modes above (their function does not depend on how keys are blocked), and
"full" is A's streamed mode, which quantizes p and V per group of `blk_k`
keys (a multiple of 64) as the streamed TPU kernel does
(`streamed_full_reference`); the pre-pass then takes V's column scales per
group. It has the same gradient through `_FlashAttention`.

Layout: q, k, v (B, L, H, D); cos/sin (B, L, D/2) tables shared by all
heads, in the working dtype. RoPE rotates interleaved pairs (2i, 2i+1).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .flash_attention_bwd import flash_attention_bwd

# Launches of kernel A since the last reset, one a call in every mode (the
# plain version on CPU tensors does not count); of its int8 tiers alone
# ("full_streamed": the "full" tier in groups of blk_k keys); of the bf16
# mode's RoPE pre-pass (two a backward with tables: the rotation and the
# pull-back); and of the int8 tiers' quantize pre-pass (one a "qk" call, two
# a "full" or "full_streamed" call: q/k, then V).
launches = 0
int8_launches = {"qk": 0, "full": 0, "full_streamed": 0}
rope_launches = 0
int8_quant_launches = 0

SOURCE = "flux_generator_tpu_torch/csrc/flash_attention_sm90.cu"  # the bf16 mode and its pre-pass
INT8_SOURCE = "flux_generator_tpu_torch/csrc/flash_attention.cu"
REPLACES = "flux_generator_tpu/ops/pallas/flash_attention.py:258"
REPLACES_STREAMED_FULL = "flux_generator_tpu/ops/pallas/flash_attention.py:292"
HEAD_DIMS = (64, 128)
INT8_TIERS = ("", "qk", "full")
_MODES = {"qk": 1, "full": 2, "full_streamed": 3}
KEY_TILE = 128  # keys a K/V tile of the int8 kernel; the pre-pass pads L to whole tiles
GROUP_KEYS = 64  # a streamed group is a multiple of this (an odd multiple runs on 64-key tiles)
# The JAX wrapper keeps the int8 tiers to its one-shot path: a padded length
# of at most 6144 (flash_attention.py:544-551).
INT8_MAX_LEN = 6144

_P = ctypes.c_void_p
_I = ctypes.c_int
_INT8_SIGNATURES = {
    "fgt_attn_int8_quant_qk": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fgt_attn_int8_quant_v": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "fgt_attn_int8_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P],
    "fgt_attn_int8_info": [_I, _I, _I, _P, _P, _P, _P],
    "fgt_attn_int8_quant_info": [_I, _I, _P, _P, _P, _P],
}
_SIGNATURES = {
    "fgt_flash_fwd_sm90": [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P],
    "fgt_flash_fwd_d64": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _I, _P],
    "fgt_rope_rotate": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fgt_flash_fwd_sm90_info": [_I, _I, _P, _P, _P, _P],
}
# Head dim 64's two kernels, by consumer warpgroups a tile (64 query rows
# each): 2, flash_fwd_sm90_kernel<64> (persistent, as at head dim 128), and 3,
# flash_fwd_d64_kernel (persistent, its last part-empty round split over
# keys).
WARPGROUPS_D64 = (2, 3)
ROWS_D64 = {2: 128, 3: 192}  # query rows a tile
# d64_geometry's and d64_split's cost model, in the time of one 128-key tile
# of two warpgroups (1.22 µs on an H100): a key tile of w warpgroups, what a
# tile costs beyond its key tiles (a tile boundary of the persistent
# kernel), what a launch of w warpgroups costs once more, and at three
# warpgroups, for a last round split over keys, what a part of a tile costs
# beyond its key tiles and a boundary (its partial values written, its
# ticket) and what the tile's last part pays a part to fold it in. Fitted to
# A's times in both geometries, split and whole, at the SD shapes and at
# whole rounds (L 4096 and 1024, B·H 33) on an H100 (within 4.2% at every
# shape of 512 keys or more), under the condition that it pick the faster
# one wherever their times' spreads do not overlap and the earlier pick
# where they do (PERF.md; scripts/prof_flash_fwd.py --geometries).
TILE_COST = {2: 1.0, 3: 1.28}
BLOCK_COST = {2: 0.4, 3: 2.0}
START_COST = {2: 3.0, 3: 4.0}
SPLIT_COST = 1.0
MERGE_COST = 0.2
PART_FLOATS = 9 * 4 * 384  # a split part's f32 values in the workspace: D64::PART_VEC4 float4 a consumer thread
# the two sources, each built into its own library
BUILDS = {"flash_attention_sm90": _SIGNATURES, "flash_attention": _INT8_SIGNATURES}


def _rope_f32(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs of x (B, L, H, D) in f32 with (B, L, D/2)
    tables — the kernel's in-register rotation."""
    shape = x.shape
    xp = x.float().reshape(*shape[:-1], shape[-1] // 2, 2)
    e, o = xp[..., 0], xp[..., 1]
    c = cos.float()[:, :, None, :]
    s = sin.float()[:, :, None, :]
    return torch.stack([e * c - o * s, e * s + o * c], dim=-1).reshape(shape)


def _div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 correctly rounded on every device. (PyTorch's CUDA division by
    a Python scalar multiplies by its reciprocal, which can round an ulp
    away; a tensor divisor on x's device takes the IEEE division.)"""
    return x / x.new_full((), 127.0)


def _quant(x: torch.Tensor, dim: int):
    """int8 levels (as f32) of f32 x with max-abs scales over `dim`: the TPU
    kernel's `_quant_rows` (over D) and `_quant_cols` (over the keys)."""
    s = _div127(x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-20))
    return torch.clamp(torch.round(x / s), -127, 127), s


def _check_tier(int8: str):
    if int8 not in INT8_TIERS:
        raise ValueError(f"int8 must be one of {INT8_TIERS}, got {int8!r}")


def flash_attention_reference(q, k, v, cos=None, sin=None, scale: Optional[float] = None,
                              int8: str = ""):
    """Plain PyTorch version of the kernel's function → (out, lse).

    out (B, L, H, D) in q's dtype, lse (B·H, L) f32. RoPE in f32 with the
    tables rounded to the working dtype, q/k rounded back to it; f32 logits
    and softmax; P rounded to the working dtype before P·V; O divided by the
    f32 row sum. The int8 tiers (see the module docstring) take their
    integer dots in f64, which holds them exactly."""
    _check_tier(int8)
    b, l, h, d = q.shape
    dt = q.dtype
    if scale is None:
        scale = d ** -0.5
    if cos is not None:
        cos, sin = cos.to(dt), sin.to(dt)
        q = _rope_f32(q, cos, sin).to(dt)
        k = _rope_f32(k, cos, sin).to(dt)
    if int8:
        qi, sq = _quant(q.float(), -1)
        ki, sk = _quant(k.float(), -1)
        dots = torch.einsum("bqhd,bkhd->bhqk", qi.double(), ki.double()).float()
        s = dots * (sq.permute(0, 2, 1, 3) * scale) * sk.permute(0, 2, 3, 1)
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    if int8 == "full":
        vi, sv = _quant(v.float(), 1)
        dots = torch.einsum("bhqk,bkhd->bhqd", torch.round(p * 127.0).double(), vi.double()).float()
        o = dots * _div127(sv.permute(0, 2, 1, 3)) / denom
    else:
        o = torch.einsum("bhqk,bkhd->bhqd", p.to(dt).float(), v.float()) / denom
    lse = (m + torch.log(denom)).reshape(b * h, l)
    return o.permute(0, 2, 1, 3).to(dt), lse


def attention_part_reference(q, k, v, keys: tuple, scale: Optional[float] = None):
    """Plain version of one part of a tile that the three-warpgroup kernel
    splits over keys: every query of (B, L, H, D) q attends to keys [k0,
    k1) = `keys` of its head, unnormalised → (o, m, l): m (B·H, L) the
    part's row max of the f32 logits (scaled), p = exp(s − m), l (B·H, L)
    the row sum of p in f32, o (B, L, H, D) f32 the product of p rounded to
    the working dtype (as P·V takes it) with v. Used by tests, never on the
    card's path."""
    b, l, h, d = q.shape
    k0, k1 = keys
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k[:, k0:k1].float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(), v[:, k0:k1].float())
    return o.permute(0, 2, 1, 3), m.reshape(b * h, l), p.sum(dim=-1).reshape(b * h, l)


def merge_parts_reference(parts, dtype=torch.float32):
    """Plain version of the kernel's merge of a split tile's parts, each
    (o, m, l) as `attention_part_reference` gives them → (out, lse): m =
    the parts' max of m, then in part order O = Σ o_p·exp(m_p − m) and l =
    Σ l_p·exp(m_p − m); out = O / l in `dtype`, lse = m + log l. Used by
    tests, never on the card's path."""
    b, l, h, _ = parts[0][0].shape
    m = torch.stack([pm for _, pm, _ in parts]).amax(dim=0)
    acc = torch.zeros_like(parts[0][0])
    denom = torch.zeros_like(m)
    for o, pm, pl in parts:
        alpha = torch.exp(pm - m)
        acc = acc + o * alpha.reshape(b, h, l).permute(0, 2, 1)[..., None]
        denom = denom + pl * alpha
    out = acc / denom.reshape(b, h, l).permute(0, 2, 1)[..., None]
    return out.to(dtype), m + torch.log(denom)


def streamed_full_reference(q, k, v, cos=None, sin=None, scale: Optional[float] = None,
                            blk_k: int = 64):
    """Plain version of kernel A's streamed "full" mode: the "full" tier as
    the JAX package's streamed kernel computes it (`_flash_kernel`, run with
    its tiers by `_flash_attention_jit`), in groups of `blk_k` keys from key
    0. Per group: m_new = max(m, the group's max logit), p = exp(s − m_new),
    p_i = rint(p / s_p) with s_p = max(max p, 1e-20)/127, V per column over
    the group's rows, acc = acc·α + (f32(Σ p_i·v_i)·s_p)·s_v and l = l·α + Σ p
    over the unquantized p. The integer dots in f64, which holds them
    exactly → (out, lse) as `flash_attention_reference`."""
    b, l, h, d = q.shape
    dt = q.dtype
    if scale is None:
        scale = d ** -0.5
    if cos is not None:
        cos, sin = cos.to(dt), sin.to(dt)
        q, k = _rope_f32(q, cos, sin).to(dt), _rope_f32(k, cos, sin).to(dt)
    qi, sq = _quant(q.float(), -1)
    ki, sk = _quant(k.float(), -1)
    s = torch.einsum("bqhd,bkhd->bhqk", qi.double(), ki.double()).float()
    s = s * (sq.permute(0, 2, 1, 3) * scale) * sk.permute(0, 2, 3, 1)
    m = torch.full((b, h, l, 1), -torch.inf, device=q.device)
    denom = torch.zeros((b, h, l, 1), device=q.device)
    acc = torch.zeros((b, h, l, d), device=q.device)
    for k0 in range(0, l, blk_k):
        sb = s[..., k0:k0 + blk_k]
        m_new = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sb - m_new)
        denom = denom * alpha + p.sum(dim=-1, keepdim=True)
        sp = _div127(p.amax(dim=-1, keepdim=True).clamp_min(1e-20))
        vi, sv = _quant(v[:, k0:k0 + blk_k].float(), 1)
        pv = torch.einsum("bhqk,bkhd->bhqd", torch.round(p / sp).double(), vi.double()).float()
        acc = acc * alpha + pv * sp * sv.permute(0, 2, 1, 3)
        m = m_new
    lse = (m + torch.log(denom)).reshape(b * h, l)
    return (acc / denom).permute(0, 2, 1, 3).to(dt), lse


def _check_cuda_args(q, k, v, cos, sin):
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash kernel takes equal (B, L, H, D) q/k/v, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dim {HEAD_DIMS}, got {q.shape[-1]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel takes contiguous q/k/v")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    if (cos is None) != (sin is None):
        raise ValueError("pass both RoPE tables or neither")
    if cos is not None:
        b, l, _, d = q.shape
        if cos.shape != (b, l, d // 2) or sin.shape != (b, l, d // 2):
            raise ValueError(f"RoPE tables must be (B, L, D/2) = {(b, l, d // 2)}, got "
                             f"{tuple(cos.shape)}/{tuple(sin.shape)}")
        if cos.device != q.device or sin.device != q.device:
            raise ValueError("RoPE tables must lie on q's device")


def _check_aligned(*tensors, align: int = 16):
    """TMA (and the pre-pass's vector loads) take base addresses and strides
    in multiples of `align` bytes: raise for a tensor that has another."""
    for t in tensors:
        if t.data_ptr() % align:
            raise ValueError(f"flash kernel takes {align}-byte aligned tensors, got a base address "
                             f"{t.data_ptr():#x} ({t.data_ptr() % align} past {align})")
        if any(st * t.element_size() % align for st in t.stride()[:-1]):
            raise ValueError(f"flash kernel takes strides of {align}-byte multiples, got {t.stride()} "
                             f"elements of {t.element_size()} bytes")


def rope_rotate_reference(q, k, cos, sin):
    """Plain version of the RoPE pre-pass: q and k rotated in f32 with the
    tables rounded to the working dtype, rounded back to it."""
    dt = q.dtype
    cos, sin = cos.to(dt), sin.to(dt)
    return _rope_f32(q, cos, sin).to(dt), _rope_f32(k, cos, sin).to(dt)


def rope_rotate(q, k, cos, sin):
    """The bf16 mode's RoPE pre-pass → (rope(q), rope(k)): its kernel on CUDA
    tensors (new tensors), its plain version on CPU ones."""
    global rope_launches
    if q.device.type == "cpu":
        return rope_rotate_reference(q, k, cos, sin)
    _check_cuda_args(q, k, q, cos, sin)
    b, l, h, d = q.shape
    cos = cos.to(q.dtype).contiguous()
    sin = sin.to(q.dtype).contiguous()
    _check_aligned(q, k)
    _check_aligned(cos, sin, align=8)
    lib = _build.load("flash_attention_sm90", _SIGNATURES)
    qr, kr = torch.empty_like(q), torch.empty_like(k)
    with torch.cuda.device(q.device):
        err = lib.fgt_rope_rotate(q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(), qr.data_ptr(),
                                  kr.data_ptr(), b, l, h, d, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("fgt_rope_rotate", err)
    rope_launches += 1
    return qr, kr


def _whole_cost(w: int, bh: int, length: int, sms: int) -> tuple:
    """(cost, CTAs) of the persistent launch of w warpgroups in whole tiles:
    its rounds of tiles (⌈tiles / CTAs⌉, one CTA an SM) times a tile's work
    (⌈L/128⌉ key tiles at TILE_COST[w], plus BLOCK_COST[w]), plus
    START_COST[w]."""
    tiles = bh * -(-length // ROWS_D64[w])
    ctas = min(tiles, sms)
    rounds = -(-tiles // ctas)
    return rounds * (-(-length // KEY_TILE) * TILE_COST[w] + BLOCK_COST[w]) + START_COST[w], ctas


@functools.lru_cache(maxsize=4096)
def d64_split(bh: int, length: int, sms: int) -> tuple:
    """The three-warpgroup launch of B·H = `bh` heads at length L on `sms`
    SMs → (CTAs, tail CTAs, cost). Whole tiles on min(tiles, SMs) CTAs,
    tail CTAs the last round's tiles (tiles % CTAs, 0 when the rounds are
    whole); or, where the last round is part-empty and the model prices it
    lower, `sms` CTAs (as many as the tail's when all tiles fit one round),
    the last round's rem tiles cut into equal ranges of key tiles over tail
    CTAs (rem < tail ≤ min(CTAs, rem·⌈L/128⌉), tail·rem·⌈L/128⌉ under 2^31
    for the kernel's 32-bit schedule): each of those CTAs runs ⌈rem·n /
    tail⌉ key tiles, two tile boundaries and SPLIT_COST, and the most-split
    tile's last part folds in its parts at MERGE_COST each. Cached: every
    UNet self-attention asks."""
    n = -(-length // KEY_TILE)
    tiles = bh * -(-length // ROWS_D64[3])
    cost, ctas = _whole_cost(3, bh, length, sms)
    best = (ctas, tiles % ctas, cost)
    full, rem = divmod(tiles, sms)
    tile = n * TILE_COST[3] + BLOCK_COST[3]
    for tail in range(rem + 1, min(sms, rem * n) + 1) if rem else ():
        if (tail + 1) * rem * n >= 2 ** 31 - 1:
            break
        per = -(-rem * n // tail)
        parts = -(-(n - 1) // (rem * n // tail)) + 1
        cost = (full * tile + per * TILE_COST[3] + 2 * BLOCK_COST[3] + SPLIT_COST + parts * MERGE_COST
                + START_COST[3])
        if cost < best[2]:
            best = (sms if full else tail, tail, cost)
    return best


def d64_tail(bh: int, length: int, ctas: int, tail: int) -> list:
    """The parts of each of the last round's tiles in a three-warpgroup
    launch on `ctas` CTAs with `tail` tail CTAs: the round's key tiles cut
    into `tail` equal ranges, as the kernel cuts them (1 for a tile run
    whole)."""
    n = -(-length // KEY_TILE)
    rem = bh * -(-length // ROWS_D64[3]) % ctas
    if tail == rem:
        return [1] * rem

    def cta_of(x):  # the range that holds key tile x of the round
        return -(-(x + 1) * tail // (rem * n)) - 1

    return [cta_of(t * n + n - 1) - cta_of(t * n) + 1 for t in range(rem)]


@functools.lru_cache(maxsize=4096)
def d64_geometry(bh: int, length: int, sms: int) -> int:
    """The consumer warpgroups (2 or 3) of the D-64 launch of B·H = `bh`
    heads at length L on `sms` SMs: the w of least cost, two warpgroups in
    whole tiles (`_whole_cost`) against three as `d64_split` plans them,
    ties to 2. Cached: every UNet self-attention asks."""
    return 3 if d64_split(bh, length, sms)[2] < _whole_cost(2, bh, length, sms)[0] else 2


# (device index, stream) → the three-warpgroup kernel's tickets on it: 1 +
# 3·SMs int32 zeros, which every launch leaves zero (a split tile's last part
# resets its ticket), so calls on one stream share them and calls on two
# streams never do; element 0 counts the merges of split tiles.
_TICKETS: dict = {}


def _d64_tickets(device: torch.device, stream: int, sms: int) -> torch.Tensor:
    key = (device.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1 + 3 * sms, dtype=torch.int32, device=device)
    return _TICKETS[key]


def d64_merges(device: Optional[torch.device] = None) -> int:
    """The split tiles the three-warpgroup kernel has merged on `device` (the
    current CUDA device by default), three a tile (one a consumer
    warpgroup), from every stream's tickets: the device's own count that the
    split path ran. Reads the card (synchronises)."""
    index = torch.device(device if device is not None else "cuda").index
    index = torch.cuda.current_device() if index is None else index
    return sum(int(t[0].item()) for (i, _), t in _TICKETS.items() if i == index)


def _sm90_launch(q, k, v, scale: float, warpgroups: Optional[int] = None, split: bool = True):
    """One launch of the bf16 kernel on CUDA tensors → (out, lse), counted
    in `launches`. At D 64 the consumer warpgroups are `d64_geometry`'s
    unless given; three warpgroups split their last round as `d64_split`
    plans, or run whole tiles with split=False."""
    global launches
    _check_cuda_args(q, k, v, None, None)
    _check_aligned(q, k, v)
    b, l, h, d = q.shape
    lib = _build.load("flash_attention_sm90", _SIGNATURES)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, l), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        sms = _build.sm_count(q.device.index or 0)  # one CTA an SM, at most one a tile
        if d == 64 and warpgroups is None:
            warpgroups = d64_geometry(b * h, l, sms)
        if warpgroups not in (None, *WARPGROUPS_D64) or (warpgroups == 3 and d != 64):
            raise ValueError(f"the bf16 kernel takes 2 consumer warpgroups, or 3 at head dim 64, got {warpgroups}")
        if warpgroups == 3:
            tiles = b * h * -(-l // ROWS_D64[3])
            ctas, tail, _ = d64_split(b * h, l, sms) if split else (min(tiles, sms), tiles % min(tiles, sms), 0)
            part = tickets = None
            if tail > tiles % ctas:  # a split tail: its parts' values and the stream's tickets
                part = torch.empty(2 * tail * PART_FLOATS, dtype=torch.float32, device=q.device)
                tickets = _d64_tickets(q.device, stream, sms)
            err = lib.fgt_flash_fwd_d64(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                                        None if part is None else part.data_ptr(),
                                        None if tickets is None else tickets.data_ptr(),
                                        b, l, h, float(scale), ctas, tail, stream)
            _build.check("fgt_flash_fwd_d64", err)
        else:
            err = lib.fgt_flash_fwd_sm90(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                         lse.data_ptr(), b, l, h, d, float(scale), sms, stream)
            _build.check("fgt_flash_fwd_sm90", err)
    launches += 1
    return out, lse


def flash_attention_sm90(q, k, v, scale: Optional[float] = None):
    """Attention without RoPE in bf16 → (out, lse): the kernel of
    csrc/flash_attention_sm90.cu on CUDA tensors (at D 64 in
    `d64_geometry`'s warpgroups), the plain version on CPU ones."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale=scale)
    return _sm90_launch(q, k, v, scale)


def sm90_kernel_info(d: int = 128, warpgroups: Optional[int] = None) -> dict:
    """The attention kernel's registers a thread at launch, spilled bytes a
    thread, shared memory a block and blocks an SM at head dim d (on the
    current CUDA device), with its geometry: warpgroups (the producer and
    the consumers), the setmaxnreg split and query rows a block. At D 64
    `warpgroups` consumer warpgroups (by default 3, the head-dim-64
    kernel); at D 128 always 2."""
    warpgroups = warpgroups or (3 if d == 64 else 2)
    lib = _build.load("flash_attention_sm90", _SIGNATURES)
    vals = [ctypes.c_int(0) for _ in range(4)]
    _build.check("fgt_flash_fwd_sm90_info", lib.fgt_flash_fwd_sm90_info(d, warpgroups,
                                                                        *(ctypes.byref(x) for x in vals)))
    info = dict(zip(("registers", "spill_bytes", "smem_bytes", "blocks_per_sm"), (x.value for x in vals)))
    return dict(info, warpgroups=warpgroups + 1, setmaxnreg=(32, 160) if warpgroups == 3 else (40, 232),
                row_block=ROWS_D64[warpgroups])


def bf16_forward(q, k, v, cos, sin, scale):
    """Kernel A's bf16 mode → (out, lse): the RoPE pre-pass when tables are
    given, then attention over the rotated q and k."""
    if (cos is None) != (sin is None):
        raise ValueError("pass both RoPE tables or neither")
    if cos is not None:
        q, k = rope_rotate(q, k, cos, sin)
    return flash_attention_sm90(q, k, v, scale)


_MODES_WITH_V = ("full", "full_streamed")


def padded_length(length: int) -> int:
    """L rounded up to whole K tiles: the pre-pass's row count a head."""
    return -(-length // KEY_TILE) * KEY_TILE


def vt_key_order(n: int) -> torch.Tensor:
    """The keys of Vᵀi in position order: within each 16, key 2t + (i & 1) +
    8 (i >> 1) sits at position 4t + i, so that an s32 tile of S rounded to
    int8 is the A fragment of the int8 P·V as it stands."""
    pos = torch.arange(n)
    kk = pos % 16
    return pos - kk + 2 * (kk // 4) + (kk % 4 & 1) + 8 * (kk % 4 >> 1)


def _check_mode(int8: str, group: int):
    if int8 not in _MODES:
        raise ValueError(f"the int8 kernel's modes are {tuple(_MODES)}, got {int8!r}")
    if int8 == "full_streamed" and (group <= 0 or group % GROUP_KEYS):
        raise ValueError(f"the streamed full tier takes groups of a positive multiple of {GROUP_KEYS} keys, "
                         f"got {group}")


def int8_prepass_reference(q, k, v, cos=None, sin=None, int8: str = "qk", group: int = 0) -> dict:
    """Plain version of the int8 tiers' quantize pre-pass over (B, L, H, D)
    q, k, v → {"qi", "qs", "ki", "ks"} and, for "full" and "full_streamed",
    {"vt", "vs"}. q and k are rotated (when tables are given) and rounded to
    the working dtype, then quantized over D as `_quant_rows`: qi, ki (B·H,
    L_pad, D) int8 and qs, ks (B·H, L_pad) f32, rows past L quantized zeros
    (L_pad = `padded_length(L)`). V is quantized per column as `_quant_cols`
    over the whole head ("full") or per group of `group` keys from key 0
    ("full_streamed", the last group zero-padded): vs (B·H, groups, D) f32,
    and vt (B·H, D, L_pad) int8, transposed, its keys in `vt_key_order`."""
    _check_mode(int8, group)
    b, l, h, d = q.shape
    l_pad = padded_length(l)
    if cos is not None:
        q, k = rope_rotate_reference(q, k, cos, sin)

    def heads(x, rows):  # (B, L, H, D) → f32 (B·H, rows, D), zeros past L
        x = x.float().permute(0, 2, 1, 3).reshape(b * h, l, d)
        return torch.nn.functional.pad(x, (0, 0, 0, rows - l))

    out = {}
    for name, x in (("q", q), ("k", k)):
        xi, sx = _quant(heads(x, l_pad), -1)
        out[f"{name}i"], out[f"{name}s"] = xi.to(torch.int8), sx[..., 0]
    if int8 in _MODES_WITH_V:
        g = l_pad if int8 == "full" else group
        n_groups = -(-l // g)
        vi, sv = _quant(heads(v, n_groups * g).reshape(b * h, n_groups, g, d), 2)
        vi = vi.reshape(b * h, n_groups * g, d)
        vi = torch.nn.functional.pad(vi, (0, 0, 0, max(l_pad - n_groups * g, 0)))[:, :l_pad]
        out["vt"] = vi.transpose(1, 2)[:, :, vt_key_order(l_pad).to(vi.device)].to(torch.int8).contiguous()
        out["vs"] = sv[:, :, 0].contiguous()
    return out


def int8_attention_reference(pre: dict, v, scale: float, int8: str = "qk", group: int = 0):
    """Plain version of the int8 attention kernel: the tier's (out, lse) from
    the pre-pass's outputs `pre` and v (B, L, H, D), as
    `flash_attention_reference` ("qk", "full") and `streamed_full_reference`
    ("full_streamed", groups of `group` keys) compute them."""
    _check_mode(int8, group)
    b, l, h, d = v.shape
    dt = v.dtype

    def heads(x):  # (B·H, L_pad, ...) → (B, H, L, ...)
        return x[:, :l].reshape(b, h, l, *x.shape[2:])

    dots = torch.einsum("bhqd,bhkd->bhqk", heads(pre["qi"]).double(), heads(pre["ki"]).double()).float()
    s = dots * (heads(pre["qs"])[..., None] * scale) * heads(pre["ks"])[:, :, None, :]
    if int8 in _MODES_WITH_V:
        vi = torch.empty_like(pre["vt"])
        vi[:, :, vt_key_order(vi.shape[-1]).to(vi.device)] = pre["vt"]
        vi = heads(vi.transpose(1, 2)).permute(0, 2, 1, 3).double()  # (B, L, H, D) levels
        sv = pre["vs"].reshape(b, h, -1, d)
    if int8 == "full_streamed":
        m = torch.full((b, h, l, 1), -torch.inf, device=v.device)
        denom = torch.zeros((b, h, l, 1), device=v.device)
        acc = torch.zeros((b, h, l, d), device=v.device)
        for gi, k0 in enumerate(range(0, l, group)):
            sb = s[..., k0:k0 + group]
            m_new = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sb - m_new)
            denom = denom * alpha + p.sum(dim=-1, keepdim=True)
            sp = _div127(p.amax(dim=-1, keepdim=True).clamp_min(1e-20))
            pv = torch.einsum("bhqk,bkhd->bhqd", torch.round(p / sp).double(), vi[:, k0:k0 + group]).float()
            acc = acc * alpha + pv * sp * sv[:, :, gi:gi + 1]
            m = m_new
        return (acc / denom).permute(0, 2, 1, 3).to(dt), (m + torch.log(denom)).reshape(b * h, l)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    if int8 == "full":
        dots = torch.einsum("bhqk,bkhd->bhqd", torch.round(p * 127.0).double(), vi).float()
        o = dots * _div127(sv) / denom
    else:
        o = torch.einsum("bhqk,bkhd->bhqd", p.to(dt).float(), v.float()) / denom
    return o.permute(0, 2, 1, 3).to(dt), (m + torch.log(denom)).reshape(b * h, l)


def int8_prepass(q, k, v, cos=None, sin=None, int8: str = "qk", group: int = 0) -> dict:
    """The int8 tiers' quantize pre-pass (see `int8_prepass_reference`): its
    kernels on CUDA tensors, one launch for "qk" and two for the "full"
    modes, into new tensors; the plain version on CPU ones."""
    global int8_quant_launches
    if q.device.type == "cpu":
        return int8_prepass_reference(q, k, v, cos, sin, int8, group)
    _check_mode(int8, group)
    _check_cuda_args(q, k, v, cos, sin)
    b, l, h, d = q.shape
    l_pad = padded_length(l)
    if cos is not None:  # tables in the working dtype, as the JAX wrapper casts them
        cos = cos.to(q.dtype).contiguous()
        sin = sin.to(q.dtype).contiguous()
        _check_aligned(cos, sin, align=8)
    _check_aligned(q, k, v)
    lib = _build.load("flash_attention", _INT8_SIGNATURES)
    dev = q.device
    pre = {name: torch.empty((b * h, l_pad, d), dtype=torch.int8, device=dev) for name in ("qi", "ki")}
    pre.update({name: torch.empty((b * h, l_pad), dtype=torch.float32, device=dev) for name in ("qs", "ks")})
    with_v = int8 in _MODES_WITH_V
    vpart = torch.empty((b * h, l_pad // GROUP_KEYS, d), dtype=torch.float32, device=dev) if with_v else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fgt_attn_int8_quant_qk(
            q.data_ptr(), k.data_ptr(), v.data_ptr() if with_v else None,
            None if cos is None else cos.data_ptr(), None if sin is None else sin.data_ptr(),
            pre["qi"].data_ptr(), pre["qs"].data_ptr(), pre["ki"].data_ptr(), pre["ks"].data_ptr(),
            None if vpart is None else vpart.data_ptr(), b, l, h, d, l_pad, stream)
        _build.check("fgt_attn_int8_quant_qk", err)
        int8_quant_launches += 1
        if with_v:
            g = l_pad if int8 == "full" else group
            pre["vt"] = torch.empty((b * h, d, l_pad), dtype=torch.int8, device=dev)
            pre["vs"] = torch.empty((b * h, -(-l // g), d), dtype=torch.float32, device=dev)
            err = lib.fgt_attn_int8_quant_v(v.data_ptr(), vpart.data_ptr(), pre["vt"].data_ptr(),
                                            pre["vs"].data_ptr(), b, l, h, d, l_pad, g, stream)
            _build.check("fgt_attn_int8_quant_v", err)
            int8_quant_launches += 1
    return pre


def int8_attention(pre: dict, v, scale: float, int8: str = "qk", group: int = 0):
    """The int8 attention kernel over the pre-pass's outputs `pre` and v (B,
    L, H, D) (bf16 P·V for "qk") → (out, lse): its kernel on CUDA tensors,
    the plain version on CPU ones."""
    global launches
    if v.device.type == "cpu":
        return int8_attention_reference(pre, v, scale, int8, group)
    _check_mode(int8, group)
    b, l, h, d = v.shape
    l_pad = padded_length(l)
    if pre["qi"].shape != (b * h, l_pad, d) or pre["ki"].shape != (b * h, l_pad, d):
        raise ValueError(f"pre-pass rows {tuple(pre['qi'].shape)} do not fit v {tuple(v.shape)}")
    vsrc = v if int8 == "qk" else pre["vt"]
    _check_aligned(vsrc, pre["qi"], pre["ki"], pre["qs"], pre["ks"])
    lib = _build.load("flash_attention", _INT8_SIGNATURES)
    out = torch.empty_like(v)
    lse = torch.empty((b * h, l), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        err = lib.fgt_attn_int8_fwd(
            pre["qi"].data_ptr(), pre["qs"].data_ptr(), pre["ki"].data_ptr(), pre["ks"].data_ptr(),
            vsrc.data_ptr(), pre["vs"].data_ptr() if int8 != "qk" else None, out.data_ptr(), lse.data_ptr(),
            b, l, h, d, l_pad, float(scale), _MODES[int8], group,
            torch.cuda.current_stream(v.device).cuda_stream)
    _build.check("fgt_attn_int8_fwd", err)
    launches += 1
    int8_launches[int8] += 1
    return out, lse


def int8_kernel_info(d: int = 128, int8: str = "full", tile: int = KEY_TILE) -> dict:
    """The int8 attention kernel's registers a thread at launch, spilled
    bytes a thread, shared memory a block and blocks an SM at head dim d,
    mode `int8` and K tile `tile` (64 only for "full_streamed")."""
    lib = _build.load("flash_attention", _INT8_SIGNATURES)
    vals = [ctypes.c_int(0) for _ in range(4)]
    _build.check("fgt_attn_int8_info", lib.fgt_attn_int8_info(d, _MODES[int8], tile,
                                                              *(ctypes.byref(x) for x in vals)))
    return dict(zip(("registers", "spill_bytes", "smem_bytes", "blocks_per_sm"), (x.value for x in vals)))


def int8_prepass_info(d: int = 128) -> dict:
    """The pre-pass kernels' registers, spilled bytes, static shared memory
    and blocks an SM at head dim d: {"qk": ..., "v": ...}."""
    lib = _build.load("flash_attention", _INT8_SIGNATURES)
    out = {}
    for which, name in enumerate(("qk", "v")):
        vals = [ctypes.c_int(0) for _ in range(4)]
        _build.check("fgt_attn_int8_quant_info", lib.fgt_attn_int8_quant_info(d, which,
                                                                              *(ctypes.byref(x) for x in vals)))
        out[name] = dict(zip(("registers", "spill_bytes", "smem_bytes", "blocks_per_sm"), (x.value for x in vals)))
    return out


def _flash_attention_cuda(q, k, v, cos, sin, scale, int8, group: int = 0):
    """Kernel A's int8 tier `int8` ("qk", "full" or "full_streamed", whose
    quantization groups are `group` keys): the quantize pre-pass, then the
    attention kernel."""
    pre = int8_prepass(q, k, v, cos, sin, int8, group)
    return int8_attention(pre, v, scale, int8, group)


def _forward(q, k, v, cos, sin, scale, int8):
    """Kernel A on CUDA tensors, its plain version on CPU ones → (out, lse)."""
    if q.device.type == "cuda":
        if not int8:
            return bf16_forward(q, k, v, cos, sin, scale)
        return _flash_attention_cuda(q, k, v, cos, sin, scale, int8)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, cos, sin, scale, int8)
    raise ValueError(f"no flash attention for device {q.device}")


def flash_attention_backward(q, k, v, cos, sin, out, lse, dout, scale: float):
    """The backward of `flash_attention` (int8 = "") → (dq, dk, dv), as
    `_flash_core_bwd` of the JAX package: rotate q and k with the tables
    (the RoPE pre-pass), form dvec = rowsum(dO·O) in f32, run kernels E and F
    (their plain version on CPU tensors) on the rotated q/k, and pull dq and
    dk back through the (orthogonal) rotation with (cos, −sin), the pre-pass
    again. Negating a table is exact, so the pull-back is the rotation's
    transpose in the working dtype."""
    b, l, h, _ = q.shape
    if cos is not None:
        q, k = rope_rotate(q, k, cos, sin)
    dout = dout.contiguous()
    dvec = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, l).contiguous()
    dq, dk, dv = flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), dout, lse, dvec, scale)
    if cos is not None:
        dq, dk = rope_rotate(dq, dk, cos, -sin)
    return dq, dk, dv


def _streamed_forward(q, k, v, cos, sin, scale, int8, blk_k):
    """The streamed path's forward → (out, lse): "" and "qk" as `_forward`,
    "full" A's streamed mode (`streamed_full_reference` on CPU tensors)."""
    if int8 != "full":
        return _forward(q, k, v, cos, sin, scale, int8)
    if q.device.type == "cuda":
        return _flash_attention_cuda(q, k, v, cos, sin, scale, "full_streamed", blk_k)
    if q.device.type == "cpu":
        return streamed_full_reference(q, k, v, cos, sin, scale, blk_k)
    raise ValueError(f"no flash attention for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """Forward kernel (or its plain version), one-shot or streamed, with the
    flash backward (`flash_attention_backward`), as `_flash_core_fwd` /
    `_flash_core_bwd` of the JAX package. cos/sin get no gradient. An int8
    tier's gradient is the straight-through estimate of the JAX package: the
    bf16 backward run on the tier's out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, scale, int8, blk_k):
        if blk_k:
            out, lse = _streamed_forward(q, k, v, cos, sin, scale, int8, blk_k)
        else:
            out, lse = _forward(q, k, v, cos, sin, scale, int8)
        ctx.save_for_backward(q, k, v, cos, sin, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, cos, sin, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, cos, sin, out, lse, dout, ctx.scale)
        return dq, dk, dv, None, None, None, None, None


def effective_int8(length: int, int8: str) -> str:
    """The int8 tier a call of this length runs: none past the one-shot
    path's length, where the JAX wrapper drops it."""
    _check_tier(int8)
    return int8 if length <= INT8_MAX_LEN else ""


def flash_attention(q, k, v, cos=None, sin=None, scale: Optional[float] = None,
                    return_lse: bool = False, int8: str = ""):
    """softmax(rope(q)·rope(k)ᵀ·scale)·v over (B, L, H, D); scale defaults to
    D^-½, RoPE applies when cos/sin (B, L, D/2) are given. Returns out, or
    (out, lse) with lse (B·H, L) f32 when return_lse. Differentiable in q, k
    and v; "" (the default) is bf16, "qk" and "full" are the int8 tiers,
    whose gradient is the bf16 backward on their out and lse."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if (cos is None) != (sin is None):
        raise ValueError("pass both RoPE tables or neither")
    int8 = effective_int8(q.shape[1], int8)
    out, lse = _FlashAttention.apply(q, k, v, cos, sin, float(scale), int8, 0)
    return (out, lse) if return_lse else out


def flash_attention_streamed(q, k, v, cos=None, sin=None, scale: Optional[float] = None, int8: str = "",
                             blk_k: int = 1024):
    """The JAX `_flash_attention_jit` on its streamed path, whose int8 tiers
    run at any length → (out, lse), lse (B·H, L) f32. "" (`bf16_forward`) and
    "qk" are kernel A's modes; "full" is A's streamed mode, quantizing p and V per group of
    `blk_k` keys (`streamed_full_reference` on CPU tensors). Differentiable in
    q, k and v as `flash_attention`: the bf16 backward on this out and lse."""
    _check_tier(int8)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if (cos is None) != (sin is None):
        raise ValueError("pass both RoPE tables or neither")
    if blk_k <= 0:
        raise ValueError(f"blk_k must be positive, got {blk_k}")
    return _FlashAttention.apply(q, k, v, cos, sin, float(scale), int8, blk_k)
