"""The fused MusicGen decode step: CUDA kernel (kernel D) and plain version.

The kernel (csrc/decode_step.cu, sm_90a) replaces the TPU kernels `_kernel`
(v1), `_kernel2` (v2) and `_kernel3` (v3) of
flux_generator_tpu/ops/pallas/decode_layer.py. The three share one contract
and differ only in how the KV-cache window reaches the TPU's VMEM; one
Hopper kernel that reads a window of any length computes all three.

Contract: `fused_decode_step(packed, x (B, H), cross_k/v (L, B, S, H), offset,
k/v_cache (L, B, W, H), cond_len) → (y (B, H), k_cache, v_cache)` runs all L
decoder layers of one AR step. Per layer: LN1 → q, k_new, v_new projections →
self-attention over cache rows < offset seeded with the current token →
o-projection + residual; LN_cross → q (the q third of the cross qkv) →
cross-attention over the text K/V, masked at cond_len[b] (NEG = -1e30, dead V
rows zeroed) → o-projection + residual; LN2 → up 4h → exact GELU → down →
residual. The new K/V rows are written into the caches at `offset`, in
place, and the caches are returned.

Numerics: weights dequantized as w.bf16 · s.bf16 rounded to bf16, dot inputs
rounded to bf16, f32 accumulation; LN in f32 with eps 1e-5; q scaled by
head_dim^-½ and rounded to bf16; attention logits in f32, the running-max
softmax divided at the end, P rounded to bf16 for P·V; the residual stream
in f32. `fused_decode_step` dispatches on the tensors' device only: CPU
tensors go to `fused_decode_step_plain`, CUDA tensors to the kernel, which
raises for inputs it does not take.

The caches are bf16 (f32 on the plain side too), or `torch.float8_e4m3fn`:
the e4m3 tier of the JAX package's FGT_MG_KV=f8, whose int8 buffers hold the
same bytes (decode_layer.py:80-117, `_f8_decode` and `store_kv_rows`). Cache
rows widen exactly on load. The new rows leave the layer stack in the
compute dtype: the current token's attention is seeded with them as they
are, and only then are they stored, e4m3 rows clamped to ±448 and rounded
to nearest even (`store_kv_rows`), as the JAX wrappers insert them after
their kernels (decode_layer.py:1229-1232).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches of the CUDA kernel since the last reset (the plain version on CPU
# tensors does not count), and those of them on e4m3 caches.
launches = 0
e4m3_launches = 0

SOURCE = "flux_generator_tpu_torch/csrc/decode_step.cu"
REPLACES = "flux_generator_tpu/ops/pallas/decode_layer.py:1083"  # v2; v1 :1180, v3 :984
# the e4m3 tier: v1, the kernel the JAX package routes e4m3 caches to
# (runtime/config.py:302-307), with its decode `_f8_decode` (l.80)
REPLACES_E4M3 = "flux_generator_tpu/ops/pallas/decode_layer.py:1180"

CPL = 14  # weight chunks per layer: q k v | o | cross q | cross o | up ×4 | down ×4
NEG = -1e30
HEAD_DIM = 64
MAX_BATCH = 8
MAX_HIDDEN = 8192

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # w, s, ln, x, ck, cv, kc, vc, cond_len, y, scratch,
    # L, B, H, S, W, offset, n_heads, w_is_int8, kv_is_e4m3, timers, stream
    "fgt_decode_step": [_P] * 11 + [_I] * 9 + [_P, _P],
    # B, H, w_is_int8 → f32 scratch the kernel needs (0: shape not taken)
    "fgt_decode_step_scratch_floats": [_I, _I, _I],
    # w_is_int8, kv_is_e4m3 → registers, spill bytes, shared bytes, blocks an SM, ring stages, syncs a layer
    "fgt_decode_step_info": [_I, _I] + [_P] * 6,
}


# ------------------------------------------------------------ packing


def _chunk_dense(p: dict, h: int, n_out: int, split: str):
    """(chunks (L, n, h, h) int8-or-float, scales (L, n, 1, h)).

    split="out": kernel (L, h, n·h) → n column chunks; split="in": kernel
    (L, n·h, h) → n row chunks sharing the per-channel scales."""
    if "kernel_q" in p:
        k, s = p["kernel_q"], p["kernel_scale"]
        if s.dim() == k.dim():
            raise ValueError("grouped quantization not packable")
    else:
        k = p["kernel"]
        s = torch.ones((*k.shape[:-2], k.shape[-1]), dtype=torch.float32, device=k.device)
    n_layers = k.shape[0]
    if split == "out":
        kc = k.reshape(n_layers, h, n_out, h).permute(0, 2, 1, 3)
        sc = s.reshape(n_layers, n_out, 1, h)
    else:
        kc = k.reshape(n_layers, n_out, h, h)
        sc = s.reshape(n_layers, 1, 1, h).expand(n_layers, n_out, 1, h)
    return kc, sc


def pack_decode_weights(layers: dict, hidden_size: int, ffn_dim: int) -> dict:
    """The stacked decoder params → the kernel's chunk stream, the layout of
    the JAX packer (decode_layer.py:146-179): w (L·14, H, H) in the weights'
    own type (int8 stays int8), s (L·14, 1, H) bf16, ln (L, 8, H) bf16 =
    [norm1, norm_cross, norm2] scale/bias pairs and two zero rows."""
    h = hidden_size
    if ffn_dim != 4 * h:
        raise ValueError(f"the chunk schedule needs ffn = 4h, got ffn {ffn_dim}, h {h}")
    qkv_w, qkv_s = _chunk_dense(layers["self_attn"]["qkv"], h, 3, "out")
    o_w, o_s = _chunk_dense(layers["self_attn"]["o"], h, 1, "out")
    xqkv_w, xqkv_s = _chunk_dense(layers["cross_attn"]["qkv"], h, 3, "out")
    xo_w, xo_s = _chunk_dense(layers["cross_attn"]["o"], h, 1, "out")
    up_w, up_s = _chunk_dense(layers["linear1"], h, 4, "out")
    dn_w, dn_s = _chunk_dense(layers["linear2"], h, 4, "in")
    w = torch.cat([qkv_w, o_w, xqkv_w[:, :1], xo_w, up_w, dn_w], dim=1)
    s = torch.cat([qkv_s, o_s, xqkv_s[:, :1], xo_s, up_s, dn_s], dim=1)
    n_layers = w.shape[0]
    w = w.reshape(n_layers * CPL, h, h).contiguous()
    s = s.reshape(n_layers * CPL, 1, h).to(torch.bfloat16).contiguous()
    zeros = torch.zeros_like(layers["norm1"]["scale"])
    ln = torch.stack([layers["norm1"]["scale"], layers["norm1"]["bias"],
                      layers["norm_cross"]["scale"], layers["norm_cross"]["bias"],
                      layers["norm2"]["scale"], layers["norm2"]["bias"], zeros, zeros],
                     dim=1).to(torch.bfloat16).contiguous()
    return {"w": w, "s": s, "ln": ln}


def packable(layers: dict) -> bool:
    """True when every decoder dense is plain (bf16/f32) or int8 with
    per-output-channel scales — the layouts the chunk packer takes."""
    parts = [layers[a][b] for a in ("self_attn", "cross_attn") for b in ("qkv", "o")]
    parts += [layers["linear1"], layers["linear2"]]
    for p in parts:
        if "kernel_q4" in p:
            return False
        if "kernel_q" in p and p["kernel_scale"].dim() == p["kernel_q"].dim():
            return False
    return True


CACHE_DTYPES = (torch.bfloat16, torch.float32, torch.float8_e4m3fn)
E4M3_MAX = 448.0


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x → float8_e4m3fn with the bytes of JAX's `astype(float8_e4m3fn)`:
    round to nearest even, and the NaN byte of x's sign past the format's
    range (|x| > 464, which would round beyond ±448) or for NaN. PyTorch's
    own conversion saturates there instead."""
    x = x.float()
    nan = (x.abs() > 464.0) | x.isnan()
    y = x.clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn).view(torch.uint8)
    nan_byte = torch.where(torch.signbit(x), 0xFF, 0x7F).to(torch.uint8)
    return torch.where(nan, nan_byte, y).view(torch.float8_e4m3fn)


def store_kv_rows(rows: torch.Tensor, cache_dtype) -> torch.Tensor:
    """New K/V rows in the cache's storage type: bf16 or f32 as they are,
    e4m3 saturated at ±448 and rounded to nearest even — the JAX
    `store_kv_rows` (decode_layer.py:103-117), which clamps so that no row
    becomes the NaN byte."""
    if cache_dtype not in CACHE_DTYPES:
        raise ValueError(f"KV cache type {cache_dtype} is not supported (bf16, f32 or e4m3)")
    if cache_dtype == torch.float8_e4m3fn:
        return to_e4m3(rows.float().clamp(-E4M3_MAX, E4M3_MAX))
    return rows.to(cache_dtype)


# ------------------------------------------------------------ plain version


def _bf(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and widen back to f32."""
    return t.to(torch.bfloat16).float()


def _ln_f32(x, scale, bias):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale.float() + bias.float()


def _attend(q, keys, values, live):
    """q (B, nh, dh) bf16-valued f32; keys/values (B, R, nh, dh) f32; live
    (B, R) bool → (B, nh, dh). Dead rows get logit NEG and zeroed V; P is
    rounded to bf16 before P·V, the row sum stays f32."""
    lo = torch.einsum("bhd,brhd->bhr", q, keys)
    lo = torch.where(live[:, None, :], lo, torch.full_like(lo, NEG))
    p = torch.exp(lo - lo.amax(dim=-1, keepdim=True))
    values = torch.where(live[:, :, None, None], values, torch.zeros_like(values))
    return torch.einsum("bhr,brhd->bhd", _bf(p), values) / p.sum(dim=-1)[..., None]


def fused_decode_step_plain(packed, x, cross_k, cross_v, offset: int, k_cache, v_cache,
                            cond_len=None, *, n_heads: int):
    """Plain PyTorch version of kernel D, one layer at a time (see the
    module docstring for the contract and numerics). The caches are written
    in place at row `offset`; the current token attends to its rows in x's
    dtype, before they are stored in the cache's."""
    w, s, ln = packed["w"], packed["s"], packed["ln"]
    n_layers = w.shape[0] // CPL
    b, h = x.shape
    dh = h // n_heads
    s_text = cross_k.shape[2]
    scale = dh ** -0.5
    if cond_len is None:
        live_text = torch.ones((b, s_text), dtype=torch.bool, device=x.device)
    else:
        live_text = torch.arange(s_text, device=x.device)[None, :] < cond_len.to(x.device)[:, None]
    live_self = torch.ones((b, offset + 1), dtype=torch.bool, device=x.device)

    def dot(a, c):
        wf = (w[c].to(torch.bfloat16) * s[c].to(torch.bfloat16)).float()
        return _bf(a) @ wf

    xs = x.float()
    for li in range(n_layers):
        c0 = li * CPL
        lnp = ln[li]
        y = _ln_f32(xs, lnp[0], lnp[1])
        q = _bf(dot(y, c0) * scale).reshape(b, n_heads, dh)
        k_row = dot(y, c0 + 1).to(x.dtype)
        v_row = dot(y, c0 + 2).to(x.dtype)
        # cache rows < offset, then the current token's own row
        keys = _bf(torch.cat([k_cache[li, :, :offset].float(), k_row[:, None].float()], dim=1))
        values = torch.cat([_bf(v_cache[li, :, :offset].float()), v_row[:, None].float()], dim=1)
        att = _attend(q, keys.reshape(b, offset + 1, n_heads, dh),
                      values.reshape(b, offset + 1, n_heads, dh), live_self)
        k_cache[li, :, offset] = store_kv_rows(k_row, k_cache.dtype)
        v_cache[li, :, offset] = store_kv_rows(v_row, v_cache.dtype)
        xs = xs + dot(att.reshape(b, h), c0 + 3)

        y = _ln_f32(xs, lnp[2], lnp[3])
        q = _bf(dot(y, c0 + 4) * scale).reshape(b, n_heads, dh)
        ck = cross_k[li].float().reshape(b, s_text, n_heads, dh)
        cv = _bf(cross_v[li].float()).reshape(b, s_text, n_heads, dh)
        att = _attend(q, _bf(ck), cv, live_text)
        xs = xs + dot(att.reshape(b, h), c0 + 5)

        y = _ln_f32(xs, lnp[4], lnp[5])
        hs = torch.cat([dot(y, c0 + 6 + j) for j in range(4)], dim=-1)
        g = torch.nn.functional.gelu(hs, approximate="none")
        acc = sum(dot(g[:, j * h:(j + 1) * h], c0 + 10 + j) for j in range(4))
        xs = xs + acc
    return xs.to(x.dtype), k_cache, v_cache


# ------------------------------------------------------------ CUDA kernel


def _check_cuda_args(packed, x, cross_k, cross_v, offset, k_cache, v_cache, cond_len, n_heads):
    w, s, ln = packed["w"], packed["s"], packed["ln"]
    if w.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"decode-step kernel takes int8 or bf16 packed weights, got {w.dtype}")
    if s.dtype != torch.bfloat16 or ln.dtype != torch.bfloat16:
        raise ValueError("decode-step kernel takes bf16 scales and LN params")
    for name, t in (("x", x), ("cross_k", cross_k), ("cross_v", cross_v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"decode-step kernel takes bf16 {name}, got {t.dtype}")
    if k_cache.dtype not in (torch.bfloat16, torch.float8_e4m3fn) or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"decode-step kernel takes bf16 or e4m3 caches of one type, got "
                         f"{k_cache.dtype}/{v_cache.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (B, H), got {tuple(x.shape)}")
    b, h = x.shape
    if w.dim() != 3 or w.shape[1:] != (h, h) or w.shape[0] % CPL:
        raise ValueError(f"packed w must be (L·{CPL}, H, H) with H = {h}, got {tuple(w.shape)}")
    n_layers = w.shape[0] // CPL
    if s.shape != (n_layers * CPL, 1, h) or ln.shape != (n_layers, 8, h):
        raise ValueError(f"packed s/ln shapes {tuple(s.shape)}/{tuple(ln.shape)} do not match w")
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"decode-step kernel takes 1..{MAX_BATCH} rows, got {b}")
    if h % 256 or h > MAX_HIDDEN or n_heads * HEAD_DIM != h:
        raise ValueError(f"decode-step kernel takes H a multiple of 256 up to {MAX_HIDDEN} and head "
                         f"dim {HEAD_DIM}, got H {h} with {n_heads} heads")
    if cross_k.dim() != 4 or cross_k.shape[:2] != (n_layers, b) or cross_k.shape[3] != h \
            or cross_v.shape != cross_k.shape:
        raise ValueError(f"cross K/V must be (L, B, S, H) = ({n_layers}, {b}, S, {h}), got "
                         f"{tuple(cross_k.shape)}/{tuple(cross_v.shape)}")
    if k_cache.dim() != 4 or k_cache.shape[:2] != (n_layers, b) or k_cache.shape[3] != h \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches must be (L, B, W, H) = ({n_layers}, {b}, W, {h}), got "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    if not 0 <= offset < k_cache.shape[2]:
        raise ValueError(f"offset {offset} outside the cache window {k_cache.shape[2]}")
    if cond_len is not None and (cond_len.dtype != torch.int32 or cond_len.shape != (b,)):
        raise ValueError(f"cond_len must be (B,) int32, got {cond_len.dtype} {tuple(cond_len.shape)}")
    tensors = [w, s, ln, x, cross_k, cross_v, k_cache, v_cache]
    if cond_len is not None:
        tensors.append(cond_len)
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("decode-step kernel takes contiguous tensors")
    if any(t.device != x.device for t in tensors):
        raise ValueError("all decode-step operands must lie on one device")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode-step kernel takes caches aligned to 16 bytes")


def _fused_decode_step_cuda(packed, x, cross_k, cross_v, offset, k_cache, v_cache, cond_len, n_heads,
                            timers=None):
    global launches, e4m3_launches
    _check_cuda_args(packed, x, cross_k, cross_v, offset, k_cache, v_cache, cond_len, n_heads)
    b, h = x.shape
    n_layers = packed["w"].shape[0] // CPL
    lib = _build.load("decode_step", _SIGNATURES)
    y = torch.empty_like(x)
    w_is_int8 = int(packed["w"].dtype == torch.int8)
    with torch.cuda.device(x.device):
        n_scratch = lib.fgt_decode_step_scratch_floats(b, h, w_is_int8)
        if n_scratch <= 0:
            raise RuntimeError("decode-step kernel: no launch plan for this device and shape")
        scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
        err = lib.fgt_decode_step(
            packed["w"].data_ptr(), packed["s"].data_ptr(), packed["ln"].data_ptr(), x.data_ptr(),
            cross_k.data_ptr(), cross_v.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            None if cond_len is None else cond_len.data_ptr(), y.data_ptr(), scratch.data_ptr(),
            n_layers, b, h, cross_k.shape[2], k_cache.shape[2], int(offset), n_heads, w_is_int8,
            int(k_cache.dtype == torch.float8_e4m3fn), None if timers is None else timers.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check("fgt_decode_step", err)
    launches += 1
    e4m3_launches += int(k_cache.dtype == torch.float8_e4m3fn)
    return y, k_cache, v_cache


def kernel_info(w_is_int8: bool = True, kv_is_e4m3: bool = False) -> dict:
    """The kernel's instantiation for int8 or bf16 weights and bf16 or e4m3
    caches: registers a thread, local memory bytes a thread (the stack of its
    calls; ptxas's report gives spills apart), shared memory bytes a block,
    blocks an SM, weight-ring stages, grid syncs a layer."""
    lib = _build.load("decode_step", _SIGNATURES)
    vals = [ctypes.c_int() for _ in range(6)]
    _build.check("fgt_decode_step_info", lib.fgt_decode_step_info(int(w_is_int8), int(kv_is_e4m3),
                                                                  *(ctypes.byref(v) for v in vals)))
    keys = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "ring_stages", "syncs_per_layer")
    return dict(zip(keys, (v.value for v in vals)))


# the kernel's phases a layer, each ended by a grid sync (the last layer's by the kernel's end)
PHASE_NAMES = ("qkv", "self-attention", "o + residual", "cross q + cross-attention", "cross o + residual",
               "up", "down + residual")


def phase_times(packed, x, cross_k, cross_v, offset: int, k_cache, v_cache, cond_len=None, *,
                n_heads: int) -> dict:
    """One launch of the kernel on CUDA tensors with block 0 stamping the
    device clock after each grid sync → {phase name: µs summed over the
    layers}, each phase from the sync before it to the sync after it (the
    slowest block's work and the sync; the last layer's down until block 0
    ends). The set-up before the first sync is not counted. The caches are
    updated as by fused_decode_step, and the launch counts."""
    n_layers = packed["w"].shape[0] // CPL
    stamps = torch.zeros(len(PHASE_NAMES) * n_layers + 1, dtype=torch.int64, device=x.device)
    _fused_decode_step_cuda(packed, x, cross_k, cross_v, offset, k_cache, v_cache, cond_len, n_heads, stamps)
    d = stamps.diff().double().cpu().reshape(n_layers, len(PHASE_NAMES)) / 1e3
    return dict(zip(PHASE_NAMES, d.sum(0).tolist()))


def fused_decode_step(packed, x, cross_k, cross_v, offset: int, k_cache, v_cache, cond_len=None,
                      *, n_heads: int):
    """All decoder layers of one AR step → (y (B, H), k_cache, v_cache);
    the caches are updated in place at row `offset`."""
    if x.device.type == "cuda":
        return _fused_decode_step_cuda(packed, x, cross_k, cross_v, offset, k_cache, v_cache,
                                       cond_len, n_heads)
    if x.device.type == "cpu":
        return fused_decode_step_plain(packed, x, cross_k, cross_v, offset, k_cache, v_cache,
                                       cond_len, n_heads=n_heads)
    raise ValueError(f"no fused decode step for device {x.device}")
