"""Euler and Euler-ancestral samplers over a sigma table (counterpart of
flux_generator_tpu/models/sd/sampler.py).

The latent x_t is kept in the reference's "scaled space" ((σ² + 1)^-½ · x),
and each step reproduces the JAX package's arithmetic: σ interpolated in f32
from the table at a continuous time, then cast to the prediction's dtype.
The sigma table and the times are tensors on the latent's device, so a step
queues its work without a host synchronisation.

Randomness: every draw is `normal(generator, shape, dtype)` from an explicit
`torch.Generator`; `add_noise` and `euler_ancestral_step` take their noise as
a tensor (where the JAX functions take a key), so the caller chooses where
it comes from.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import DiffusionConfig


def make_sigmas(cfg: DiffusionConfig) -> np.ndarray:
    """σ table (num_train_steps + 1,) f32; index 0 = 0 (clean), the last the
    most noise."""
    if cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, cfg.num_train_steps)
    elif cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, cfg.num_train_steps) ** 2
    else:
        raise NotImplementedError(cfg.beta_schedule)
    alphas_cumprod = np.cumprod(1 - betas)
    return np.concatenate([np.zeros(1), np.sqrt((1 - alphas_cumprod) / alphas_cumprod)]).astype(np.float32)


def interp_sigma(sigmas: torch.Tensor, t) -> torch.Tensor:
    """σ at continuous time t, linearly interpolated in f32 from the table
    (a f32 tensor); t a tensor or a number, the result on the table's
    device."""
    t = torch.as_tensor(t, dtype=torch.float32, device=sigmas.device)
    n = sigmas.shape[0]
    lo = torch.clamp(t.to(torch.int32), 0, n - 1)
    hi = torch.clamp(lo + 1, max=n - 1)
    frac = t - lo
    return sigmas[lo.long()] * (1 - frac) + frac * sigmas[hi.long()]


def max_time(sigmas) -> int:
    return len(sigmas) - 1


def timesteps(sigmas, num_steps: int, start_time=None) -> np.ndarray:
    start = float(start_time if start_time is not None else len(sigmas) - 1)
    assert 0 < start <= len(sigmas) - 1
    return np.linspace(start, 0, num_steps + 1).astype(np.float32)


def normal(generator: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Standard-normal noise of `shape` drawn in f32 on the generator's
    device, cast to `dtype`."""
    return torch.randn(tuple(shape), generator=generator, device=generator.device,
                       dtype=torch.float32).to(dtype)


def sample_prior(generator: torch.Generator, sigmas: np.ndarray, shape, dtype) -> torch.Tensor:
    """x_T: noise · σ_max / √(σ_max² + 1) in f32, cast to `dtype`."""
    s_max = sigmas[-1]
    return (normal(generator, shape) * float(s_max) / float(np.sqrt(s_max**2 + 1))).to(dtype)


def add_noise(noise: torch.Tensor, sigmas: torch.Tensor, x: torch.Tensor, t) -> torch.Tensor:
    """x noised to time t: (x + noise·σ) / √(σ² + 1), σ in x's dtype."""
    s = interp_sigma(sigmas, t).to(x.dtype)
    return (x + noise.to(x.dtype) * s) * torch.rsqrt(s * s + 1)


def euler_step(sigmas: torch.Tensor, eps_pred, x_t, t, t_prev):
    sigma = interp_sigma(sigmas, t).to(eps_pred.dtype)
    sigma_prev = interp_sigma(sigmas, t_prev).to(eps_pred.dtype)
    dt = sigma_prev - sigma
    x = torch.sqrt(sigma**2 + 1) * x_t + eps_pred * dt
    return x * torch.rsqrt(sigma_prev**2 + 1)


def euler_ancestral_step(noise: torch.Tensor, sigmas: torch.Tensor, eps_pred, x_t, t, t_prev):
    """The ancestral Euler step with its noise given (x_t's shape; the JAX
    function draws it from its key)."""
    sigma = interp_sigma(sigmas, t).to(eps_pred.dtype)
    sigma_prev = interp_sigma(sigmas, t_prev).to(eps_pred.dtype)
    sigma2, sigma_prev2 = sigma**2, sigma_prev**2
    sigma_up = torch.sqrt(sigma_prev2 * (sigma2 - sigma_prev2) / sigma2)
    sigma_down = torch.sqrt(sigma_prev2 - sigma_up**2)
    dt = sigma_down - sigma
    x = torch.sqrt(sigma2 + 1) * x_t + eps_pred * dt
    x = x + noise.to(x.dtype) * sigma_up
    return x * torch.rsqrt(sigma_prev2 + 1)
