"""Explicit device and random-generator helpers.

The port never picks a device behind the caller's back: every constructor
takes a `device`, and every random draw takes a `torch.Generator` created on
that device. Which kernels run follows from where the tensors lie (see
ops/kernels/), not from any switch here.
"""

from __future__ import annotations

from typing import Optional

import torch


def as_device(device) -> torch.device:
    """Normalise a device spec ("cuda", "cuda:0", torch.device, None→cpu)."""
    if device is None:
        return torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_generator(device, seed: Optional[int] = None) -> torch.Generator:
    """A generator on `device`, seeded with `seed` (0 when None)."""
    g = torch.Generator(device=as_device(device))
    g.manual_seed(0 if seed is None else int(seed))
    return g


def synchronize(device) -> None:
    """Wait for queued work on `device` (host clocks around device work
    measure only the enqueue without this); no-op on the CPU."""
    device = as_device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
