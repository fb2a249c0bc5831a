"""Explicit device and random-generator helpers.

Entry points run on the card unless the caller asks for the CPU: a device
spec of None means the current CUDA device, and it is an error where there
is none (there is no fallback to the CPU). Every random draw takes a
`torch.Generator` created on the device it draws for. Which kernels run
follows from where the tensors lie (see ops/kernels/), not from any switch
here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def as_device(device) -> torch.device:
    """Normalise a device spec ("cuda", "cuda:0", "cpu", torch.device;
    None → the current CUDA device, raising when there is no card)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card by default; pass "
                               "device='cpu' (or a CPU generator) to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
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


def to_device(data, dtype, device: torch.device) -> torch.Tensor:
    """Host data (a list, numpy array or CPU tensor) as a `dtype` tensor on
    `device`. On the card it goes through pinned memory as an asynchronous
    copy, so the host does not wait for the device's queue to drain."""
    t = torch.as_tensor(np.asarray(data) if not isinstance(data, torch.Tensor) else data, dtype=dtype)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
