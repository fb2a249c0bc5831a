"""Parameter bridge and tree helpers.

Parameters keep the JAX package's tree layout: nested dicts (and lists for
heterogeneous VAE levels) of tensors, dense kernels stored (in, out), convs
HWIO, homogeneous transformer stacks stacked on a leading layer axis, and
quantized dense leaves under `kernel_q` (int8), `kernel_q4` (uint8, two int4
nibbles per byte, split layout) and `kernel_scale` (f32, (…, out) per channel
or (…, groups, out) per input group; unpacked int4 `kernel_q` is held as
int8 with `kernel_int4` beside it), and LoRA adapters under `lora_a` /
`lora_b`. So one converter serves trees built by the JAX package (tests),
optimizer states included.

Checkpoints reach the same layout through the port's own modules: the key
mappers of `io/sanitize.py` (the port's copy of the JAX package's) turn a
flat checkpoint into flat canonical paths, applying the weight transforms
below (linear (out,in)→(in,out); conv2d OIHW→HWIO; conv1d OIK→KIO;
convtranspose1d IOK→KIO with a time flip), and `unflatten` assembles them,
stacking homogeneous layer stacks on a leading axis.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.quant import INT4_MARK, int4_mark, to_k_major


def tree_map(fn: Callable, tree):
    """Apply `fn` to every leaf of a dict/list/tuple tree (named tuples,
    such as optax's optimizer states, keep their type)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def take_layer(tree, i: int):
    """Layer `i` of a stacked (leading layer axis) subtree — the loop body's
    view where the JAX package scans."""
    return tree_map(lambda x: x[i], tree)


def num_layers(tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def stack_layers(make_layer: Callable, n: int):
    """Build `n` layers with `make_layer()` into one tree stacked on a leading
    axis, writing each layer into preallocated tensors as it is drawn: the
    transient is one layer, not a second copy of the stack (which matters at
    full width, where a stack is up to 13 GB in bf16)."""
    first = make_layer()
    out = tree_map(lambda x: x.new_empty((n, *x.shape)), first)

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, make_layer(), i)
    return out


def _np_to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    name = a.dtype.name
    if name == "bfloat16":  # ml_dtypes.bfloat16: reinterpret the raw bits
        return torch.from_numpy(np.array(a, copy=True).view(np.int16)).view(torch.bfloat16)
    if name == "int4":  # native int4 (unpacked) weights widen to int8
        a = a.astype(np.int8)
    return torch.from_numpy(np.array(a, copy=True))


def _mark_int4(src, out):
    """Torch has no int4 tensors, so unpacked int4 `kernel_q` leaves widen to
    int8; keep the fact beside them (ops.quant.INT4_MARK), so that `dense`
    keeps them weight-only as the JAX package does."""
    if isinstance(src, dict):
        q = src.get("kernel_q")
        if q is not None and np.asarray(q).dtype.name == "int4":
            out[INT4_MARK] = int4_mark(out["kernel_q"])
        for k, v in src.items():
            _mark_int4(v, out[k])
    elif isinstance(src, (list, tuple)):
        for s, o in zip(src, out):
            _mark_int4(s, o)


def to_torch(tree, device=None, dtype=None):
    """numpy (or array-like) leaf tree → torch tensors on `device`. `dtype`,
    when given, casts floating leaves only; integer (quantized) leaves keep
    their type and values, int8 per-channel kernels stored K-contiguous, the
    port's layout for them (ops.quant), and unpacked int4 ones widened to
    int8 with INT4_MARK beside them."""

    def conv(a):
        if isinstance(a, (int, float, bool)) or a is None:
            return a
        t = _np_to_torch(a)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device) if device is not None else t

    out = tree_map(conv, tree)
    _mark_int4(tree, out)
    return to_k_major(out)


def _torch_to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_numpy(tree):
    """torch tensor tree → numpy arrays (bf16 as ml_dtypes.bfloat16)."""
    return tree_map(lambda t: _torch_to_np(t) if isinstance(t, torch.Tensor) else t, tree)


# ------------------------------------------------------------ checkpoint assembly


def unflatten(flat: dict, stack_prefixes=()):
    """flat {"a.0.b.kernel": tensor} → nested dicts and lists; integer-keyed
    subtrees whose path (integers left out) is in `stack_prefixes` are
    stacked into one tree of leading-axis tensors (the JAX package's
    io/params.unflatten)."""
    root = {}
    for path, value in flat.items():
        parts = path.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def is_int_keyed(d):
        return isinstance(d, dict) and d and all(k.isdigit() for k in d)

    def convert(node, path):
        if not isinstance(node, dict):
            return node
        if is_int_keyed(node):
            # index gaps become empty dicts: parameterless entries (EnCodec's
            # ELU slots) never appear in checkpoints
            n = max(int(i) for i in node) + 1
            items = [convert(node.get(str(i), {}), path + (str(i),)) for i in range(n)]
            if path and ".".join(p for p in path if not p.isdigit()) in stack_prefixes:
                return _stack_trees(items)
            return items
        return {k: convert(v, path + (k,)) for k, v in node.items()}

    return convert(root, ())


def _stack_trees(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack_trees([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack([torch.as_tensor(t) for t in trees])


def t_linear(w: torch.Tensor) -> torch.Tensor:
    """torch Linear (out, in) → dense kernel (in, out)."""
    return w.t().contiguous()


def t_conv2d(w: torch.Tensor) -> torch.Tensor:
    """OIHW → HWIO."""
    return w.permute(2, 3, 1, 0).contiguous()


def t_conv1d(w: torch.Tensor) -> torch.Tensor:
    """OIK → KIO."""
    return w.permute(2, 1, 0).contiguous()


def t_convtr1d(w: torch.Tensor) -> torch.Tensor:
    """ConvTranspose1d (in, out, k) → the lhs-dilated conv kernel (k, in,
    out), flipped in time (models/musicgen/encodec._dec_convtr)."""
    return w.permute(2, 0, 1).flip(0).contiguous()
