"""LoRA adapters over plain-dict params (counterpart of
flux_generator_tpu/training/lora.py).

lora_a ~ U(−1/√in, 1/√in) of shape (…, in, r), lora_b zeros of shape
(…, r, out), update y += (x @ A) @ B with scale 1 (ops/linear.dense), fusing
returns the base kernel + A @ B. Every linear of the double and single
blocks gets an adapter; the blocks are stacked on a leading layer axis, so
the adapters are stacked too — one (L, in, r) / (L, r, out) pair per linear
site — and "the last N blocks only" is a per-layer 0/1 mask on that axis.
"""

from __future__ import annotations

import math

import torch

_LORA = ("lora_a", "lora_b")


def _is_dense(p) -> bool:
    return isinstance(p, dict) and "kernel" in p and p["kernel"].dim() >= 2


def _add_lora(p: dict, generator: torch.Generator, rank: int) -> dict:
    """lora_a/lora_b for one (possibly layer-stacked) dense param dict, in
    the kernel's dtype, on its device."""
    kern = p["kernel"]
    *lead, d_in, d_out = kern.shape
    bound = 1 / math.sqrt(d_in)
    u = torch.rand((*lead, d_in, rank), generator=generator, device=kern.device, dtype=torch.float32)
    a = ((u * 2 - 1) * bound).to(kern.dtype)
    b = torch.zeros((*lead, rank, d_out), dtype=kern.dtype, device=kern.device)
    return {**p, "lora_a": a, "lora_b": b}


def _map_dense(tree, fn):
    if _is_dense(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_dense(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_dense(v, fn) for v in tree]
    return tree


def apply_lora_to_flux(flow_params: dict, rank: int = 8, generator=None) -> dict:
    """Inject LoRA into every linear of the double/single stream blocks,
    drawing A from `generator` (seed 0 on the params' device when None)."""
    if generator is None:
        device = flow_params["double_blocks"]["img_mod"]["kernel"].device
        generator = torch.Generator(device=device).manual_seed(0)
    out = dict(flow_params)
    for name in ("double_blocks", "single_blocks"):
        out[name] = _map_dense(flow_params[name], lambda p: _add_lora(p, generator, rank))
    return out


def lora_only_filter(params):
    """Bool tree: True on lora_a/lora_b leaves (the trainable set)."""

    def walk(node, under_lora=False):
        if isinstance(node, dict):
            return {k: walk(v, k in _LORA) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return under_lora

    return walk(params)


def lora_block_mask(flow_params: dict, num_blocks: int, depth: int, depth_single: int) -> dict:
    """Per-leaf multiplier tree: on lora leaves a (L, 1, 1) 0/1 mask in the
    leaf's dtype, on every other leaf a scalar 0. With num_blocks > 0 only
    the LAST num_blocks of [double_blocks + single_blocks] train."""
    total = depth + depth_single
    n = num_blocks if num_blocks > 0 else total
    # block index b (0..total-1) trains iff b >= total - n
    masks = {"double_blocks": torch.arange(depth) >= (total - n),
             "single_blocks": torch.arange(depth_single) >= (total - n - depth)}

    def walk(node, mask):
        if isinstance(node, dict):
            return {k: (mask.reshape((-1,) + (1,) * (v.dim() - 1)).to(v.device, v.dtype)
                        if k in _LORA and mask is not None else walk(v, mask))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, mask) for v in node]
        return torch.zeros(())  # non-lora leaves: scalar 0 (unused)

    return {k: walk(v, masks.get(k)) for k, v in flow_params.items()}


def extract_lora(tree):
    """Prune to the lora_a/lora_b leaves (same nesting, empty branches
    dropped). Training takes gradients over this tree only."""

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k in _LORA:
                    out[k] = v
                else:
                    sub = walk(v)
                    if sub is not None:
                        out[k] = sub
            return out or None
        if isinstance(node, list):
            subs = [walk(v) for v in node]
            return subs if any(s is not None for s in subs) else None
        return None

    return walk(tree) or {}


def merge_lora(full, lora):
    """Overlay an extract_lora tree back onto the full param tree."""
    if lora is None:
        return full
    if isinstance(full, dict):
        out = dict(full)
        for k, v in lora.items():
            out[k] = merge_lora(full.get(k), v) if k not in _LORA else v
        return out
    if isinstance(full, list):
        return [merge_lora(f, l) for f, l in zip(full, lora)]
    return lora


def fuse_lora(params):
    """Fold adapters into unquantized kernels: W += A @ B (scale 1); the
    adapter keys go. Quantized kernels keep their adapters."""

    def walk(node):
        if _is_dense(node) and "lora_a" in node:
            delta = torch.einsum("...ir,...ro->...io", node["lora_a"], node["lora_b"])
            kern = node["kernel"] + delta.to(node["kernel"].dtype)
            return {k: v for k, v in {**node, "kernel": kern}.items() if k not in _LORA}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)
