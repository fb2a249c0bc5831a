"""Ring attention: sequence parallelism over a mesh axis (counterpart of
flux_generator_tpu/parallel/ring_attention.py).

q, k and v are split along the sequence over the ranks of an axis. Each rank
attends its L/n queries to the K/V shard it holds with kernel A
(`flash_attention_sm90`, no RoPE: RoPE is applied to the whole sequence
first), which gives that fold's normalised output and its log-sum-exp; the
folds merge in f32 by the running log-sum-exp rule, and the K/V shards hop
one rank around the ring (`batch_isend_irecv`) until every query has seen
every key. The next shard's transfer starts before a fold and is waited for
after it; the last fold sends nothing. On CPU tensors the folds run kernel
A's plain version.

A rank holds O(L/n · D) of K/V and attends (L/n)² logits a fold. There is
no gradient through the ring (the JAX package takes none).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.kernels.flash_attention import flash_attention_sm90, rope_rotate
from .mesh import Mesh, all_gather


def merge_fold(state, out: torch.Tensor, lse: torch.Tensor):
    """Fold one shard's attention (out (B, L, H, D) normalised over that
    shard's keys, lse (B·H, L) f32) into the running state (acc f32
    (B, L, H, D), lse (B, L, H, 1)); state None starts it."""
    b, l, h, _ = out.shape
    lse = lse.reshape(b, h, l).transpose(1, 2)[..., None]
    if state is None:
        return out.float(), lse
    acc, run = state
    new = torch.logaddexp(run, lse)
    return acc * torch.exp(run - new) + out.float() * torch.exp(lse - new), new


def fold_and_merge(q: torch.Tensor, shards, scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q (B, Lq, H, D) over the keys of every (k, v) shard in
    `shards` (each (B, Lk, H, D), RoPE already applied): one kernel A fold a
    shard, merged in f32 → (B, Lq, H, D) in q's dtype."""
    state = None
    for k, v in shards:
        state = merge_fold(state, *flash_attention_sm90(q, k, v, scale))
    return state[0].to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, axis: str = "model",
                   scale: Optional[float] = None) -> torch.Tensor:
    """Full (non-causal) attention of this rank's sequence shards q, k, v
    (B, L/n, H, D), the n ranks of `axis` holding consecutive shards in axis
    order → this rank's output shard (B, L/n, H, D). Apply RoPE before
    calling."""
    n = mesh.size(axis)
    group, line, me = mesh.group(axis), mesh.line(axis), mesh.index(axis)
    state = None
    for i in range(n):
        pending = ()
        if i < n - 1:
            k_next, v_next = torch.empty_like(k), torch.empty_like(v)
            nxt, prv = line[(me + 1) % n], line[(me - 1) % n]
            pending = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, k, nxt, group), dist.P2POp(dist.isend, v, nxt, group),
                dist.P2POp(dist.irecv, k_next, prv, group), dist.P2POp(dist.irecv, v_next, prv, group)])
        state = merge_fold(state, *flash_attention_sm90(q, k, v, scale))
        for req in pending:
            req.wait()
        if pending:
            k, v = k_next, v_next
    return state[0].to(q.dtype)


def ring_attention_rope(q, k, v, cos, sin, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """The model's ring dispatch: the whole sequence q, k, v (B, L, H, D),
    replicated on the ranks of `axis`, rotated with RoPE (kernel A's
    pre-pass on the card), this rank's L/n slice attended around the ring,
    and the output gathered back whole."""
    n, i = mesh.size(axis), mesh.index(axis)
    q, k = rope_rotate(q, k, cos, sin)
    c = q.shape[1] // n

    def local(x):
        return x[:, i * c:(i + 1) * c].contiguous()

    return all_gather(ring_attention(local(q), local(k), local(v), mesh, axis), mesh, axis, dim=1)
