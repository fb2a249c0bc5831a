"""Multi-process initialization (counterpart of
flux_generator_tpu/parallel/distributed.py).

One process drives one device. `initialize_multihost` joins the processes
into a `torch.distributed` group: from its arguments, or from the RANK /
WORLD_SIZE / MASTER_ADDR / MASTER_PORT that `torchrun` sets. The backend
follows the device: NCCL for a CUDA device, gloo for the CPU. Afterwards the
same mesh code (parallel/mesh.py) lays the group out as ("data", "model")
axes, as the JAX package lays its devices out after
`jax.distributed.initialize`.
"""

from __future__ import annotations

import os
import warnings

import torch
import torch.distributed as dist

from ..runtime.device import as_device


def backend_for(device) -> str:
    return "nccl" if as_device(device).type == "cuda" else "gloo"


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None, device=None,
                         init_method=None):
    """Join (or create) the process group; a no-op in a single process with
    no group asked for, and when a group already exists.

    coordinator_address "host:port" is rank 0's address (tcp://), or pass an
    `init_method` URL ("file://…", "tcp://…"); with neither, torchrun's
    MASTER_ADDR / MASTER_PORT ("env://"). num_processes and process_id
    default to WORLD_SIZE and RANK. `device` (the current CUDA device when
    None) picks the backend; with torchrun's LOCAL_RANK set, that CUDA device
    becomes current first. A failure to join raises when more than one
    process was asked for, and warns for a group of one, as the JAX
    package's no-op on a single process."""
    if dist.is_initialized():
        return
    env = os.environ
    asked = any(v is not None for v in (coordinator_address, num_processes, process_id, init_method)) \
        or "WORLD_SIZE" in env
    if not asked:
        return
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if init_method is None:
        init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    if device is None and "LOCAL_RANK" in env and torch.cuda.is_available():
        torch.cuda.set_device(int(env["LOCAL_RANK"]))
    device = as_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        dist.init_process_group(backend_for(device), init_method=init_method, world_size=world, rank=rank)
    except (ValueError, RuntimeError) as e:
        if world > 1:
            raise
        warnings.warn(f"running without a process group: {e}")


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_info() -> dict:
    """The JAX package's keys: this process's index, the process count, and
    the devices this process drives (one) and the group spans."""
    return {
        "process_index": rank(),
        "process_count": world_size(),
        "local_devices": 1,
        "global_devices": world_size(),
    }


def shutdown() -> None:
    """Destroy the default group (and every group made from it)."""
    if dist.is_initialized():
        dist.destroy_process_group()
