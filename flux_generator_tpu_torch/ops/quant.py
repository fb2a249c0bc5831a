"""Weight-only quantization (counterpart of flux_generator_tpu/ops/quant.py).

Symmetric per-output-channel or per-input-group quantization of (in, out)
dense kernels, with f32 scales: int8 under `kernel_q`, or int4 packed two per
byte under `kernel_q4` in the SPLIT nibble layout — packed row r holds
original row r in the low nibble and row r + in/2 in the high nibble, both
biased by +8. The int4 matmul kernel (ops/kernels/int4_matmul.py) reads that
layout directly. An int8 kernel with per-channel scales is stored
K-contiguous: the same (…, in, out) values with strides (…, 1, in), the layout
in which the W8A8 kernel and cuBLAS's int8 GEMM read the weight (int8 tensor
cores take that operand along K only), and which every other path takes as
well. `quantize_dense` writes it so, and `to_k_major` relays a tree built
elsewhere (the JAX bridge).
"""

from __future__ import annotations

import torch


# Unpacked int4 weights are held as int8 `kernel_q` (torch has no int4
# tensors) with this leaf beside them: a bool tensor of the kernel's leading
# (layer) dims, so that it slices with the stack. `dense` keeps such a kernel
# weight-only under every W8A8 route, as the JAX package keeps its int4 dtype.
INT4_MARK = "kernel_int4"


def int4_mark(q: torch.Tensor) -> torch.Tensor:
    return torch.ones(q.shape[:-2], dtype=torch.bool, device=q.device)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(…, in, out) ints in [-8, 7] → (…, in/2, out) uint8, split layout."""
    q = q.to(torch.int32) + 8
    half = q.shape[-2] // 2
    lo = q[..., :half, :]
    hi = q[..., half:, :]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """Inverse of pack_int4: (…, in/2, out) uint8 → (…, in, out)."""
    p = packed.to(torch.int32)
    low = (p & 0xF) - 8
    high = (p >> 4) - 8
    return torch.cat([low, high], dim=-2).to(dtype)


def _quantize_2d(kern: torch.Tensor, qmax: float, group_size):
    """One (in, out) kernel → (q as f32 integers, scale (out,) or (g, out))."""
    kern = kern.float()
    if group_size:
        d_in, d_out = kern.shape
        kg = kern.reshape(d_in // group_size, group_size, d_out)
        scale = (kg.abs().amax(dim=-2, keepdim=True) / qmax).clamp_min(1e-8)
        q = torch.clamp(torch.round(kg / scale), -qmax, qmax).reshape(d_in, d_out)
        return q, scale.squeeze(-2)
    scale = (kern.abs().amax(dim=-2, keepdim=True) / qmax).clamp_min(1e-8)
    q = torch.clamp(torch.round(kern / scale), -qmax, qmax)
    return q, scale.squeeze(-2)


def quantize_dense(p: dict, bits: int = 8, group_size: int = None,
                   pack: bool = False) -> dict:
    """Quantize one dense param dict (layer-stacked kernels included).

    Stacked kernels are quantized one layer at a time into preallocated
    outputs, so the f32 working copy is one layer, not the whole stack (the
    12B flow's largest stack is 10 GB in f32)."""
    kern = p["kernel"]
    qmax = 127.0 if bits == 8 else 7.0
    d_in, d_out = kern.shape[-2], kern.shape[-1]
    if group_size and d_in % group_size:
        raise ValueError(f"input dim {d_in} is not a multiple of group size {group_size}")
    if pack:
        if bits != 4:
            raise ValueError("nibble packing is a 4-bit format")
        if group_size and (d_in // 2) % group_size:
            # split layout: each half must hold whole groups
            raise ValueError(f"half input dim {d_in // 2} must hold whole groups of {group_size}")
    lead = kern.shape[:-2]
    flat = kern.reshape(-1, d_in, d_out)
    n = flat.shape[0]
    q_rows = d_in // 2 if pack else d_in
    k_major = bits == 8 and not group_size
    q_shape = (n, d_out, q_rows) if k_major else (n, q_rows, d_out)
    q_out = torch.empty(q_shape, dtype=torch.uint8 if pack else torch.int8, device=kern.device)
    s_shape = (n, d_in // group_size, d_out) if group_size else (n, d_out)
    s_out = torch.empty(s_shape, dtype=torch.float32, device=kern.device)
    for i in range(n):
        q, s = _quantize_2d(flat[i], qmax, group_size)
        q_out[i] = pack_int4(q) if pack else (q.t() if k_major else q).to(torch.int8)
        s_out[i] = s
    if k_major:
        q_out = q_out.transpose(-1, -2)
    out = {k: v for k, v in p.items() if k != "kernel"}
    out["kernel_q4" if pack else "kernel_q"] = q_out.reshape(*lead, q_rows, d_out)
    out["kernel_scale"] = s_out.reshape(*lead, *s_shape[1:])
    if bits == 4 and not pack:
        out[INT4_MARK] = int4_mark(out["kernel_q"])
    return out


def default_predicate(p) -> bool:
    """Quantize linears whose input dim is a multiple of 512 — skips the
    small projections (same rule as the JAX package)."""
    return p["kernel"].shape[-2] % 512 == 0


def quantize_tree(params, predicate=default_predicate, bits: int = 8,
                  group_size: int = None, pack: bool = False):
    """Quantize every dense dict in a param tree that `predicate` accepts.
    A kernel whose input dim is not a multiple of `group_size` falls back
    to per-channel scales, as in the JAX package."""

    def walk(node):
        if isinstance(node, dict):
            if "kernel" in node and node["kernel"].ndim >= 2 and predicate(node):
                gs = group_size
                if gs and node["kernel"].shape[-2] % gs != 0:
                    gs = None
                return quantize_dense(node, bits, group_size=gs, pack=pack)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def quantize_pipeline(pipeline, predicate=default_predicate, bits: int = 8,
                      text_encoder_bits: int = None):
    """Quantize the big matmul weights of a pipeline in place: the flow or
    the UNet at `bits`, then T5 and the CLIP encoders at `text_encoder_bits`
    (`bits` when None). The reference's "4-bit text encoders + 8-bit unet"
    is bits=8, text_encoder_bits=4.

    Dense kernels only: a 4-D conv kernel stays as it is. The JAX package
    hands every kernel to `predicate`, so a UNet conv with 2560 inputs
    (SDXL's up path) is quantized there and its conv then finds no
    "kernel"; the port keeps convs out, as the SD loader's int8 policy
    does."""

    def dense_only(p):
        return p["kernel"].ndim <= 3 and predicate(p)

    for name in ("flow", "unet"):
        if name in pipeline.params:
            pipeline.params[name] = quantize_tree(pipeline.params[name], dense_only, bits)
    te_bits = text_encoder_bits or bits
    for name in ("t5", "clip", "clip_2"):
        if name in pipeline.params:
            pipeline.params[name] = quantize_tree(pipeline.params[name], dense_only, te_bits)
    return pipeline


def is_k_major(q: torch.Tensor) -> bool:
    """(…, K, N) stored K-contiguous: strides (…, 1, K) (any stride where a
    dim is 1)."""
    k, n = q.shape[-2:]
    return (k == 1 or q.stride(-2) == 1) and (n == 1 or q.stride(-1) == k)


def to_k_major(tree):
    """Store every int8 per-channel `kernel_q` of a tree K-contiguous (see
    the module docstring), in place; one already so stays as it is. Each
    tensor is replaced as it is relaid, so no tree holds both layouts.
    Returns the tree."""
    if isinstance(tree, dict):
        q, scale = tree.get("kernel_q"), tree.get("kernel_scale")
        if (q is not None and q.dtype == torch.int8 and INT4_MARK not in tree and scale is not None
                and scale.dim() == q.dim() - 1 and not is_k_major(q)):
            tree["kernel_q"] = q.transpose(-1, -2).contiguous().transpose(-1, -2)
            del q
        for v in tree.values():
            to_k_major(v)
    elif isinstance(tree, list):
        for v in tree:
            to_k_major(v)
    return tree


def quantize_tree_to_device(params, predicate=default_predicate, bits: int = 8, group_size: int = None,
                            pack: bool = False, dtype=None, device=None):
    """`quantize_tree` of a host tree, streamed to `device` one tensor at a
    time (the JAX package's quantize_tree_to_device): each accepted dense
    kernel is quantized on the CPU and only its int8 or packed copy moves,
    so the full-precision tree never lies on the card beside its quantized
    copy. Floating leaves that are not quantized, and the biases of those
    that are, are cast to `dtype` first; the scales stay f32."""

    def put(x):
        return x.to(device) if device is not None else x

    def walk(node):
        if isinstance(node, dict):
            if "kernel" in node and node["kernel"].ndim >= 2 and predicate(node):
                gs = group_size if group_size and node["kernel"].shape[-2] % group_size == 0 else None
                q = quantize_dense({k: v.cpu() for k, v in node.items()}, bits, group_size=gs, pack=pack)
                if dtype is not None and "bias" in q:
                    q["bias"] = q["bias"].to(dtype)
                return {k: put(v) for k, v in q.items()}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if dtype is not None and node.is_floating_point():
            node = node.to(dtype)
        return put(node)

    return to_k_major(walk(params))
