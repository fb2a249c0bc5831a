"""Rectified-flow sampler (counterpart of flux_generator_tpu/models/flux/sampler.py):
linear 1→0 schedule, the dev models' resolution-dependent time shift, and
the Euler step x + (t_prev − t)·pred."""

from __future__ import annotations

import math

import numpy as np
import torch


def time_shift(image_seq_len: float, t, base_shift: float = 0.5, max_shift: float = 1.15):
    """Dev-model sigmoid schedule shift over sequence length 256→4096."""
    x1, x2 = 256.0, 4096.0
    mu = (image_seq_len - x1) * (max_shift - base_shift) / (x2 - x1) + base_shift
    exp_mu = math.exp(mu)
    return exp_mu / (exp_mu + (1.0 / t - 1.0))


def flux_timesteps(num_steps: int, image_seq_len: int, schnell: bool = True,
                   start: float = 1.0, stop: float = 0.0, base_shift: float = 0.5,
                   max_shift: float = 1.15) -> np.ndarray:
    t = np.linspace(start, stop, num_steps + 1)
    if not schnell:
        with np.errstate(divide="ignore"):
            t = time_shift(image_seq_len, t, base_shift, max_shift)
        t = np.nan_to_num(t, nan=0.0)  # t=0 endpoint
    return t


def flux_step(pred, x_t, t, t_prev):
    """Euler step of the probability-flow ODE."""
    return x_t + (t_prev - t) * pred


def sample_prior(generator: torch.Generator, shape, dtype, device=None) -> torch.Tensor:
    """Standard-normal prior drawn from `generator` (on the generator's
    device unless `device` says otherwise)."""
    device = generator.device if device is None else device
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32).to(dtype)
