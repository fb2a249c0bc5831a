"""Tensor-parallel sharding of parameter trees (counterpart of
flux_generator_tpu/parallel/sharding.py).

`logical_sharding` is the JAX package's rule, copied: a kernel whose path
matches `_ROW_PAT` is split on its input axis ("row"), one that matches
`_COL_PAT` on its output axis ("col"), everything else is replicated. GSPMD
then places activations and inserts the collectives.

Here each rank holds only its shard and the model code runs the collectives
itself (models/flux/model.py, models/t5/t5.py), so `shard_params` follows an
explicit Megatron plan, `TP_PLAN`, by dense module, on the logical (in, out)
axes of every leaf of the module:

  col    — output features split; the rank's output is its slice (qkv and
           linear1 by head, each of their parts split alike; the MLP's
           first dense; the embedders' in_layer; T5's q, k, v and wi);
  row    — input features split, matching the col slice before it; the
           partial products are summed across ranks, then the bias added
           once (proj, linear2 with the same [attention heads | MLP] split
           as linear1, the MLP's second dense, out_layer, T5's o and wo);
  gather — output features split, the output gathered whole (the
           modulations, 3.2 B of Flux's 12 B parameters).

Where that differs from the JAX rule (the MLP's first dense and the
modulations, which JAX replicates and GSPMD reshards around; a 1-D
per-channel scale, which JAX replicates beside its split kernel; T5's
relative-bias table, split by head), it is because a rank here holds only
its slice of the computation. Quantized leaves split on their logical axes
too: scales follow their kernel's output split (per channel) or whole input
groups (grouped), int8 per-channel weights keep their K-contiguous layout,
and split-layout int4 is unpacked, split on logical K and packed again per
shard.
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist

from ..io.params import tree_leaves
from ..ops.quant import INT4_MARK, is_k_major, pack_int4, unpack_int4
from .mesh import MODEL_AXIS, Mesh, broadcast

# path-regex → PartitionSpec for the kernel (the JAX package's rule)
_COL_PAT = re.compile(
    r"(qkv|linear1|to_q|to_k|to_v|query|key|value|q\b|k\b|v\b|wi|wi_0|wi_1|"
    r"in_layer|fc1|mlp/0|img_mlp/0|txt_mlp/0|lin\b|proj_in|up_proj|gate_proj)"
)
_ROW_PAT = re.compile(
    r"(proj\b|linear2|to_out|out\b|o\b|wo|out_layer|fc2|mlp/2|img_mlp/2|"
    r"txt_mlp/2|proj_out|down_proj)"
)


def _spec_for(path: str, leaf) -> tuple:
    """The JAX PartitionSpec of a leaf as a tuple of axis names (None: not
    split; () replicated)."""
    if leaf.dim() < 2 or "kernel" not in path:
        return ()
    lead = (None,) * (leaf.dim() - 2)
    if _ROW_PAT.search(path):
        return (*lead, MODEL_AXIS, None)
    if _COL_PAT.search(path):
        return (*lead, None, MODEL_AXIS)
    return ()


def _classify(spec: tuple) -> str:
    if not spec:
        return "replicated"
    return "col" if spec[-1] == MODEL_AXIS else "row"


def _walk_paths(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _walk_paths(v, fn, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk_paths(v, fn, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def logical_sharding(params, mesh=None):
    """Per leaf, the JAX package's classification: "col", "row" or
    "replicated" (the mesh is not needed to classify)."""
    return _walk_paths(params, lambda path, leaf: _classify(_spec_for(path, leaf)))


# ------------------------------------------------------------ the port's plan

TP_PLAN = {
    # Flux
    "qkv": "col", "linear1": "col", "in": "col", "in_layer": "col",
    "proj": "row", "linear2": "row", "out": "row", "out_layer": "row",
    "img_mod": "gather", "txt_mod": "gather", "modulation": "gather",
    # T5
    "q": "col", "k": "col", "v": "col", "wi": "col", "wi_0": "col", "wi_1": "col",
    "o": "row", "wo": "row",
}
_HEAD_TABLES = ("rel_bias",)  # (buckets, heads): split by head


def _is_dense(node) -> bool:
    return isinstance(node, dict) and any(k in node for k in ("kernel", "kernel_q", "kernel_q4"))


def _logical_in_out(p: dict) -> tuple:
    if "kernel_q4" in p:
        return 2 * p["kernel_q4"].shape[-2], p["kernel_q4"].shape[-1]
    w = p["kernel"] if "kernel" in p else p["kernel_q"]
    return w.shape[-2], w.shape[-1]


def _parts(key: str, d_in: int, d_out: int, role: str) -> list:
    """The parts of the split axis, each split alike across ranks: q, k and v
    of qkv; q, k, v and the MLP of linear1; attention and MLP rows of
    linear2 (linear1's input width is the hidden size, linear2's output)."""
    if key == "qkv":
        return [d_out // 3] * 3
    if key == "linear1":
        return [d_in] * 3 + [d_out - 3 * d_in]
    if key == "linear2":
        return [d_out, d_in - d_out]
    return [d_in if role == "row" else d_out]


def _split(t: torch.Tensor, dim: int, parts: list, n: int, r: int) -> torch.Tensor:
    """Rank r's n-th of each part of `dim`, concatenated, in a tensor of its
    own (no view of the whole)."""
    pieces, off = [], 0
    for size in parts:
        if size % n:
            raise ValueError(f"a part of {size} features does not split over {n} ranks")
        c = size // n
        pieces.append(t.narrow(dim, off + r * c, c))
        off += size
    return torch.cat(pieces, dim) if len(pieces) > 1 else pieces[0].clone()


def _merge(ts: list, dim: int, parts: list) -> torch.Tensor:
    """Inverse of `_split` over the ranks' shards; `parts` are a shard's."""
    out, off = [], 0
    for size in parts:
        out += [t.narrow(dim, off, size) for t in ts]
        off += size
    return torch.cat(out, dim)


def _like(src: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """`out` in `src`'s layout: K-contiguous int8 stays K-contiguous."""
    if src.dim() >= 2 and is_k_major(src) and not src.is_contiguous():
        return out.transpose(-1, -2).contiguous().transpose(-1, -2)
    return out.contiguous()


def _group_parts(parts: list, group: int, n: int) -> list:
    for size in parts:
        if size % (n * group):
            raise ValueError(f"a part of {size} input rows does not split into whole groups of {group} "
                             f"over {n} ranks")
    return [size // group for size in parts]


def shard_dense(p: dict, key: str, role: str, n: int, r: int) -> dict:
    """Rank r's shard of one dense module (layer-stacked leaves included)."""
    d_in, d_out = _logical_in_out(p)
    parts = _parts(key, d_in, d_out, role)
    out = {}
    for name, t in p.items():
        if name == INT4_MARK:
            out[name] = t
        elif role in ("col", "gather"):
            keep = name == "lora_a"
            out[name] = t if keep else _like(t, _split(t, -1, parts, n, r))
        elif name in ("kernel", "kernel_q", "lora_a"):
            out[name] = _like(t, _split(t, -2, parts, n, r))
        elif name == "kernel_q4":
            local = _split(unpack_int4(t), -2, parts, n, r)
            if local.shape[-2] % 2:
                raise ValueError(f"an int4 shard of {local.shape[-2]} rows cannot pack in two halves")
            out[name] = pack_int4(local)
        elif name == "kernel_scale" and t.dim() == (p.get("kernel_q", p.get("kernel_q4"))).dim():
            group = d_in // t.shape[-2]  # grouped: whole groups of the input rows
            if "kernel_q4" in p and (d_in // n // 2) % group:
                raise ValueError(f"each half of an int4 shard of {d_in // n} rows must hold whole "
                                 f"groups of {group}")
            out[name] = _split(t, -2, _group_parts(parts, group, n), n, r)
        else:  # per-channel scale, bias, lora_b: added after the sum, whole
            out[name] = t
    return out


def _unshard_dense(ps: list, key: str, role: str) -> dict:
    n = len(ps)
    d_in, d_out = _logical_in_out(ps[0])
    if role == "row":
        d_in *= n
    else:
        d_out *= n
    parts = [size // n for size in _parts(key, d_in, d_out, role)]  # a shard's parts
    out = {}
    for name, t in ps[0].items():
        ts = [p[name] for p in ps]
        if name == INT4_MARK or (role in ("col", "gather") and name == "lora_a"):
            out[name] = t
        elif role in ("col", "gather"):
            out[name] = _like(t, _merge(ts, -1, parts))
        elif name in ("kernel", "kernel_q", "lora_a"):
            out[name] = _like(t, _merge(ts, -2, parts))
        elif name == "kernel_q4":
            out[name] = pack_int4(_merge([unpack_int4(x) for x in ts], -2, parts))
        elif name == "kernel_scale" and t.dim() == (ps[0].get("kernel_q", ps[0].get("kernel_q4"))).dim():
            group = d_in // n // t.shape[-2]
            out[name] = _merge(ts, -2, [size // group for size in parts])
        else:
            out[name] = t
    return out


def shard_tree(tree, n: int, r: int):
    """Rank r of n's local tree under `TP_PLAN` (a new tree; `tree` is kept)."""

    def walk(node, key):
        if _is_dense(node):
            role = TP_PLAN.get(key)
            return shard_dense(node, key, role, n, r) if role else node
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        if key in _HEAD_TABLES:
            return _split(node, -1, [node.shape[-1]], n, r)
        return node

    return walk(tree, None)


def unshard_trees(trees: list):
    """The whole tree from the ranks' local trees, in rank order."""

    def walk(nodes, key):
        node = nodes[0]
        if _is_dense(node):
            role = TP_PLAN.get(key)
            return _unshard_dense(nodes, key, role) if role else node
        if isinstance(node, dict):
            return {k: walk([x[k] for x in nodes], k) for k in node}
        if isinstance(node, list):
            return [walk([x[i] for x in nodes], key) for i in range(len(node))]
        if key in _HEAD_TABLES:
            return torch.cat(nodes, -1)
        return node

    return walk(trees, None)


def shard_params(params, mesh: Mesh, axis: str = MODEL_AXIS):
    """This rank's local tree: `params` (the same tree on every rank) split
    over `axis` of `mesh` by `TP_PLAN`. On an axis of one rank, `params`
    itself."""
    n = mesh.size(axis)
    return params if n == 1 else shard_tree(params, n, mesh.index(axis))


def _gather_leaf(t: torch.Tensor, mesh: Mesh, axis: str) -> list:
    group = mesh.group(axis)
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src, group=group)
    return [_like(t, x) for x in parts]


def unshard(local, mesh: Mesh, axis: str = MODEL_AXIS):
    """The whole tree, on every rank, from each rank's `shard_params` tree
    (every leaf gathered across `axis`)."""
    n = mesh.size(axis)
    if n == 1:
        return local

    def per_rank(node) -> list:  # the n ranks' versions of `node`
        if isinstance(node, dict):
            subs = {k: per_rank(v) for k, v in node.items()}
            return [{k: v[i] for k, v in subs.items()} for i in range(n)]
        if isinstance(node, list):
            subs = [per_rank(v) for v in node]
            return [[v[i] for v in subs] for i in range(n)]
        return _gather_leaf(node, mesh, axis)

    return unshard_trees(per_rank(local))


def _broadcast_leaf(t: torch.Tensor, mesh: Mesh, axis: str):
    buf = t if t.is_contiguous() else t.mT
    if not buf.is_contiguous():
        raise ValueError(f"cannot broadcast a tensor of strides {t.stride()} in place")
    broadcast(buf, mesh, axis, 0)


def replicate(tree, mesh: Mesh):
    """The tree of the mesh's first rank on every rank, in place (each axis
    in turn broadcasts from its coordinate 0); returns the tree."""
    for axis in reversed(list(mesh.shape)):
        if mesh.size(axis) > 1:
            for leaf in tree_leaves(tree):
                _broadcast_leaf(leaf, mesh, axis)
    return tree
