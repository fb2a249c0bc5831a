"""Rectified-flow sampler (counterpart of flux_generator_tpu/models/flux/sampler.py):
linear 1→0 schedule, the dev models' resolution-dependent time shift, the
Euler step x + (t_prev − t)·pred, and the training-time noising and
timestep draws."""

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


def add_noise(x: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Linear interpolation x·(1 − t) + t·noise, t (B,) cast to x's dtype."""
    t = t.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
    return x * (1 - t) + t * noise


def random_timesteps(generator: torch.Generator, batch: int, image_seq_len: int,
                     schnell: bool = True) -> torch.Tensor:
    """Training timesteps (B,) f32 on the generator's device: schnell draws
    from {1/4, 2/4, 3/4, 4/4}; dev draws uniformly, then applies the
    resolution shift."""
    device = generator.device
    if schnell:
        return torch.randint(1, 5, (batch,), generator=generator, device=device).float() / 4
    t = torch.rand((batch,), generator=generator, device=device, dtype=torch.float32)
    x1, x2 = 256.0, 4096.0
    mu = (image_seq_len - x1) * (1.15 - 0.5) / (x2 - x1) + 0.5
    exp_mu = math.exp(mu)
    return exp_mu / (exp_mu + (1.0 / t - 1.0))
