"""Process mesh (counterpart of flux_generator_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ("data", "model") `Mesh` and lets
GSPMD insert the collectives. Here one process drives one device, so a mesh
lays process ranks out on named axes (row-major) and holds, for each axis,
the `torch.distributed` group of the ranks that share this rank's other
coordinates; the model code calls the collectives below on those groups.
Without a process group the mesh is one rank and every collective is the
identity.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .distributed import rank, world_size

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """Named axes over process ranks. `axes` maps each axis name to its size,
    outermost first; `ranks` (default 0 … n − 1) are the global ranks laid
    out row-major. Every process of the group must build the same meshes in
    the same order: each builds every axis line's group."""

    def __init__(self, axes: dict, ranks: Optional[Sequence[int]] = None):
        self.shape = dict(axes)
        n = math.prod(self.shape.values())
        ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
        if len(ranks) != n:
            raise ValueError(f"mesh {self.shape} holds {n} ranks, got {len(ranks)}")
        if max(ranks) >= world_size():
            raise ValueError(f"mesh {self.shape} needs ranks {ranks}, the group has {world_size()}")
        grid = np.array(ranks).reshape(tuple(self.shape.values()))
        self.ranks = grid
        me = rank()
        found = np.argwhere(grid == me)
        self.coords = dict(zip(self.shape, (int(c) for c in found[0]))) if len(found) else None
        self._lines = {}
        for i, axis in enumerate(self.shape):
            for line in np.moveaxis(grid, i, -1).reshape(-1, self.shape[axis]).tolist():
                group = dist.new_group(line) if dist.is_initialized() else None
                if me in line:
                    self._lines[axis] = (group, line)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of this rank's line along `axis` (None without
        a process group)."""
        return self._lines[axis][0]

    def line(self, axis: str) -> list:
        """The global ranks of this rank's line along `axis`, in axis order."""
        return self._lines[axis][1]


def create_mesh(data: Optional[int] = None, model: int = 1, devices=None) -> Mesh:
    """A ("data", "model") mesh over `devices` (global ranks; all ranks of
    the group when None). With data=None, all remaining ranks go on the
    data axis."""
    ranks = list(devices) if devices is not None else list(range(world_size()))
    n = len(ranks)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh({DATA_AXIS: data, MODEL_AXIS: model}, ranks)


def local_mesh() -> Mesh:
    """A mesh over every rank of the group, data-parallel only."""
    return create_mesh(model=1)


# ------------------------------------------------------------ collectives
# Each is the identity on an axis without a process group.


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum x over `axis`, in place; returns x."""
    group = mesh.group(axis)
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = -1) -> torch.Tensor:
    """The ranks' x concatenated along `dim` in axis order."""
    group = mesh.group(axis)
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str, src: int = 0) -> torch.Tensor:
    """x of the rank at coordinate `src` on `axis`, on every rank, in place."""
    group = mesh.group(axis)
    if group is not None:
        dist.broadcast(x, src=mesh.line(axis)[src], group=group)
    return x
