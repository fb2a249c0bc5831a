"""Pipeline parallelism: GPipe over a layer stack (counterpart of
flux_generator_tpu/parallel/pipeline.py).

The layer stacks keep the JAX package's layout, stacked on a leading depth
axis. With S stages on a mesh axis, stage s holds layers [s·d/S, (s+1)·d/S)
(`shard_pipeline_params`: a rank keeps only its chunk) and `pipeline_scan`
replaces the loop over layers with a GPipe schedule:

  - the batch is split into M microbatches;
  - at tick t, stage s runs its chunk on microbatch t − s (stage 0 takes it
    from the input, the others receive it from the stage before), then
    sends the activation on to the next stage;
  - M + S − 1 ticks drain the pipe (bubble (S − 1)/(M + S − 1));
  - the last stage holds the result and broadcasts it to every stage, where
    the JAX package sums the stages' (mostly zero) outputs.

The schedule is differentiable: under autograd it keeps each microbatch's
graph, and its backward runs the schedule in reverse, each hop sending the
gradient of the activation it received back one stage. The gradients of the
per-example extras are summed over the stages that used them, and the
input's gradient comes from stage 0.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..io.params import num_layers, take_layer, tree_leaves, tree_map
from ..ops.quant import to_k_major
from .mesh import Mesh, broadcast


class StageStack(dict):
    """One stage's chunk of a layer stack (a dict tree whose leaves have the
    chunk's layers on their leading axis), with the whole stack's `depth`."""

    def __init__(self, tree: dict, depth: int):
        super().__init__(tree)
        self.depth = depth


def _leading_dim(tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def default_microbatches(batch: int, stages: int) -> int:
    """The largest divisor of the batch that fits the stage count (a batch of
    3 on 2 stages runs as 1 microbatch)."""
    m = min(batch, stages)
    while batch % m:
        m -= 1
    return m


def _run_chunk(body, x, chunk, extras):
    for i in range(num_layers(chunk)):
        x = body(x, take_layer(chunk, i), *extras)
    return x


def _unflat(xs, single: bool):
    return xs[0] if single else tuple(xs)


def _flat(x) -> list:
    return [x] if isinstance(x, torch.Tensor) else list(x)


class _Schedule:
    """One pipeline_scan call's schedule on this rank: stage `s` of `stages`
    on the group `group` (global ranks `line`), `m` microbatches."""

    def __init__(self, body, mesh: Mesh, axis: str, m: int, single: bool, n_carry: int, chunk_of):
        self.body, self.mesh, self.axis, self.m = body, mesh, axis, m
        self.stages, self.s = mesh.size(axis), mesh.index(axis)
        self.group, self.line = mesh.group(axis), mesh.line(axis)
        self.single, self.n_carry, self.chunk_of = single, n_carry, chunk_of

    def _send(self, xs, stage):
        return [dist.isend(x.contiguous(), self.line[stage], group=self.group) for x in xs]

    def _recv(self, likes, stage):
        xs = [torch.empty_like(x) for x in likes]
        for x in xs:
            dist.recv(x, self.line[stage], group=self.group)
        return xs

    def forward(self, carry_mb, extras_mb, params, keep_graph: bool):
        """Run the ticks → (the output microbatches, concatenated and
        broadcast from the last stage, and the kept graphs)."""
        chunk = self.chunk_of(params)
        s, last = self.s, self.stages - 1
        outputs, kept, sends = [None] * self.m, [], []
        for t in range(self.m + self.stages - 1):
            mb = t - s
            if not 0 <= mb < self.m:
                continue
            xs = carry_mb[mb] if s == 0 else self._recv(carry_mb[mb], s - 1)
            ex = extras_mb[mb]
            if keep_graph:
                xs = [x.detach().requires_grad_(True) for x in xs]
                ex = [e.detach().requires_grad_(e.requires_grad) for e in ex]
            ys = _flat(_run_chunk(self.body, _unflat(xs, self.single), chunk, ex))
            if keep_graph:
                kept.append((mb, xs, ex, ys))
            if s < last:
                sends += self._send([y.detach() for y in ys], s + 1)
            else:
                outputs[mb] = [y.detach() for y in ys]
        for req in sends:
            req.wait()
        if s == last:
            out = [torch.cat([o[j] for o in outputs]) for j in range(self.n_carry)]
        else:
            out = [torch.empty((x.shape[0] * self.m, *x.shape[1:]), dtype=x.dtype, device=x.device)
                   for x in carry_mb[0]]
        for x in out:
            broadcast(x, self.mesh, self.axis, last)
        return out, kept

    def backward(self, kept, grad_out, carry_mb, extras_mb, params):
        """The reverse schedule → (carry grads from stage 0, extras grads
        summed over the stages, this stage's param grads)."""
        s, last = self.s, self.stages - 1
        g_carry = [None] * self.m
        g_extras = [[None] * len(extras_mb[0]) for _ in range(self.m)]
        g_params = [None] * len(params)
        sends = []
        for mb, xs, ex, ys in reversed(kept):
            if s == last:
                gys = [g.chunk(self.m)[mb] for g in grad_out]
            else:
                gys = self._recv(ys, s + 1)
            ex_in = [e for e in ex if e.requires_grad]
            p_in = [p for p in params if p.requires_grad]
            grads = torch.autograd.grad(ys, xs + ex_in + p_in, gys, allow_unused=True)
            gx, grads = grads[:len(xs)], grads[len(xs):]
            gx = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, gx)]
            if s > 0:
                sends += self._send(gx, s - 1)
            else:
                g_carry[mb] = gx
            it = iter(grads)
            for j, e in enumerate(ex):
                if e.requires_grad:
                    g_extras[mb][j] = next(it)
            for j, p in enumerate(params):
                if p.requires_grad:
                    g = next(it)
                    if g is not None:
                        g_params[j] = g if g_params[j] is None else g_params[j] + g
        for req in sends:
            req.wait()
        carry_grads = []
        for j, like in enumerate(carry_mb[0]):
            g = torch.cat([g_carry[mb][j] for mb in range(self.m)]) if s == 0 else \
                torch.empty((like.shape[0] * self.m, *like.shape[1:]), dtype=like.dtype, device=like.device)
            carry_grads.append(broadcast(g, self.mesh, self.axis, 0))
        extras_grads = []
        for j, like in enumerate(extras_mb[0]):
            if not like.requires_grad:
                extras_grads.append(None)
                continue
            g = torch.cat([torch.zeros_like(like) if g_extras[mb][j] is None else g_extras[mb][j]
                           for mb in range(self.m)])
            group = self.mesh.group(self.axis)
            if group is not None:
                dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
            extras_grads.append(g)
        return carry_grads, extras_grads, g_params


class _GPipe(torch.autograd.Function):
    """The schedule under autograd; see the module docstring."""

    @staticmethod
    def forward(ctx, sched: _Schedule, n_carry: int, n_extras: int, *flat):
        carry, extras, params = flat[:n_carry], flat[n_carry:n_carry + n_extras], flat[n_carry + n_extras:]
        with torch.enable_grad():
            params = [p.detach().requires_grad_(p.requires_grad) for p in params]
            carry_mb = list(zip(*[c.chunk(sched.m) for c in carry]))
            extras_mb = list(zip(*[e.detach().requires_grad_(e.requires_grad).chunk(sched.m)
                                   for e in extras])) or [()] * sched.m
            out, kept = sched.forward([list(x) for x in carry_mb], [list(e) for e in extras_mb], params, True)
        ctx.sched, ctx.kept, ctx.params = sched, kept, params
        ctx.carry_mb = [[x.detach() for x in xs] for xs in carry_mb]
        ctx.extras_mb = [list(ex) for ex in extras_mb]
        ctx.n_carry = n_carry
        return tuple(out)

    @staticmethod
    def backward(ctx, *grad_out):
        g_carry, g_extras, g_params = ctx.sched.backward(ctx.kept, list(grad_out), ctx.carry_mb,
                                                         ctx.extras_mb, ctx.params)
        ctx.kept = None
        return (None, None, None, *g_carry, *g_extras, *g_params)


def pipeline_scan(body: Callable, carry, stacked_params, mesh: Mesh, axis: str = "pipe",
                  microbatches: Optional[int] = None, extras=()):
    """Run `body` over the layers of `stacked_params` with the stack
    pipelined over the `mesh.size(axis)` stages of `axis`.

    body(carry, layer_params, *extras) → new carry, of carry's shapes.
    `carry` (a tensor or a tuple of tensors) and every tensor of `extras`
    have a leading batch dimension, split into `microbatches` microbatches
    (by default the largest divisor of the batch up to the stage count); the
    stage running a microbatch gets that microbatch's slice of the extras.
    `stacked_params` is the whole stack (each stage then takes its chunk) or
    this stage's `StageStack` (`shard_pipeline_params`).

    Returns the final carry on every stage: the sequential loop's result,
    layer for layer (batch-pointwise bodies only)."""
    single = isinstance(carry, torch.Tensor)
    stages = mesh.size(axis)
    if stages == 1:
        return _run_chunk(body, carry, stacked_params, extras)
    local = isinstance(stacked_params, StageStack)
    depth = stacked_params.depth if local else _leading_dim(stacked_params)
    if depth % stages:
        raise ValueError(f"depth {depth} not divisible by {stages} pipeline stages")
    carry_l, extras_l = _flat(carry), list(extras)
    batch = carry_l[0].shape[0]
    m = default_microbatches(batch, stages) if microbatches is None else microbatches
    if batch % m:
        raise ValueError(f"batch {batch} not divisible by {m} microbatches")
    per = depth // stages
    s = mesh.index(axis)
    chunk = dict(stacked_params) if local else tree_map(lambda x: x[s * per:(s + 1) * per], stacked_params)
    leaves = tree_leaves(chunk)

    def chunk_of(params):
        it = iter(params)
        return tree_map(lambda _: next(it), chunk)

    sched = _Schedule(body, mesh, axis, m, single, len(carry_l), chunk_of)
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in carry_l + extras_l + leaves)
    if needs_grad:
        out = _GPipe.apply(sched, len(carry_l), len(extras_l), *carry_l, *extras_l, *leaves)
    else:
        carry_mb = [list(x) for x in zip(*[c.chunk(m) for c in carry_l])]
        extras_mb = [list(e) for e in zip(*[e.chunk(m) for e in extras_l])] or [[] for _ in range(m)]
        out, _ = sched.forward(carry_mb, extras_mb, leaves, False)
    return _unflat(list(out), single)


def pad_stack(stacked_params, stages: int):
    """Zero-pad a layer stack's depth up to a multiple of `stages` →
    (padded, original depth).

    A zero block is the identity for Flux's gated-residual blocks when every
    weight of it dequantizes to 0: a float or int8 kernel of zeros with zero
    scales, and packed int4, whose zero byte decodes to −8, with zero scales
    (the padding zeroes every leaf). So pad after quantizing, as the JAX
    package does. Int8 per-channel kernels keep their K-contiguous layout."""
    depth = _leading_dim(stacked_params)
    pad = (-depth) % stages
    if pad == 0:
        return stacked_params, depth
    padded = tree_map(lambda x: torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]), stacked_params)
    return to_k_major(padded), depth


def pipeline_stage_sharding(stacked_params, mesh: Mesh, axis: str = "pipe"):
    """Per leaf, the JAX package's placement spec: the leading depth axis
    split over `axis`, the rest whole."""
    return tree_map(lambda leaf: (axis,) + (None,) * (leaf.dim() - 1), stacked_params)


def shard_pipeline_params(stacked_params, mesh: Mesh, axis: str = "pipe") -> StageStack:
    """This stage's chunk of the stack, in tensors of its own (the stack
    itself on one stage)."""
    stages = mesh.size(axis)
    depth = _leading_dim(stacked_params)
    if depth % stages:
        raise ValueError(f"depth {depth} not divisible by {stages} pipeline stages")
    if stages == 1:
        return StageStack(stacked_params, depth)
    per, s = depth // stages, mesh.index(axis)
    chunk = tree_map(lambda x: x[s * per:(s + 1) * per].clone(), stacked_params)
    return StageStack(to_k_major(chunk), depth)


def pipeline_tp_sharding(stacked_params, mesh: Mesh, pipe_axis: str = "pipe", model_axis: str = "model"):
    """PP × TP: this rank's chunk of the stack on `pipe_axis`, each of its
    dense modules split over `model_axis` by parallel/sharding.TP_PLAN; the
    stage body's tensor-parallel collectives run on the model axis."""
    from .sharding import shard_params

    stage = shard_pipeline_params(stacked_params, mesh, pipe_axis)
    return StageStack(shard_params(dict(stage), mesh, model_axis), stage.depth)
