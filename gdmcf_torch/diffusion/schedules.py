"""Beta schedules and diffusion coefficient tables.

Port of the JAX package's ``diffusion/schedules.py``: the tables are computed
on the host in float64 and stored as float32 tensors (the reference casts to
float32 at every lookup anyway)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def betas_from_linear_variance(steps: int, variance: np.ndarray,
                               max_beta: float = 0.999) -> np.ndarray:
    """Betas whose cumulative variance (1 - alpha_bar) is the given ramp."""
    alpha_bar = 1.0 - variance
    betas = [1.0 - alpha_bar[0]]
    for i in range(1, steps):
        betas.append(min(1.0 - alpha_bar[i] / alpha_bar[i - 1], max_beta))
    return np.array(betas, dtype=np.float64)


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar,
                        max_beta: float = 0.999) -> np.ndarray:
    """Betas from a continuous alpha_bar(t) function (cosine schedule)."""
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def get_betas(noise_schedule: str, steps: int, noise_scale: float,
              noise_min: float, noise_max: float,
              beta_fixed: bool = True) -> np.ndarray:
    """Named beta schedule, float64; ``beta_fixed`` pins beta[0] to 1e-5."""
    if noise_schedule in ("linear", "linear-var"):
        start = noise_scale * noise_min
        end = noise_scale * noise_max
        ramp = np.linspace(start, end, steps, dtype=np.float64)
        betas = (ramp if noise_schedule == "linear"
                 else betas_from_linear_variance(steps, ramp))
    elif noise_schedule == "cosine":
        betas = betas_for_alpha_bar(
            steps, lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2)
    elif noise_schedule == "binomial":
        betas = np.array([1.0 / (steps - t + 1) for t in range(steps)],
                         dtype=np.float64)
    else:
        raise NotImplementedError(f"unknown beta schedule: {noise_schedule}!")
    betas = np.array(betas, dtype=np.float64)
    if beta_fixed:
        betas[0] = 0.00001
    assert betas.ndim == 1 and len(betas) == steps
    assert (betas > 0).all() and (betas <= 1).all(), "betas out of range"
    return betas


class DiffusionCoeffs(NamedTuple):
    """Per-step tables, float32 tensors of length ``steps``."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor


def compute_coeffs(betas: np.ndarray, device=None) -> DiffusionCoeffs:
    """Tables computed in float64, stored as float32 on ``device``."""
    betas = np.asarray(betas, dtype=np.float64)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas, axis=0)
    ac_prev = np.concatenate([[1.0], ac[:-1]])
    ac_next = np.concatenate([ac[1:], [0.0]])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    # log-variance clipped at t=0 by reusing the t=1 entry
    post_log_var = np.log(np.concatenate([post_var[1:2], post_var[1:]]))

    def dev(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=device)

    return DiffusionCoeffs(
        betas=dev(betas),
        alphas_cumprod=dev(ac),
        alphas_cumprod_prev=dev(ac_prev),
        alphas_cumprod_next=dev(ac_next),
        sqrt_alphas_cumprod=dev(np.sqrt(ac)),
        sqrt_one_minus_alphas_cumprod=dev(np.sqrt(1.0 - ac)),
        log_one_minus_alphas_cumprod=dev(np.log(1.0 - ac)),
        sqrt_recip_alphas_cumprod=dev(np.sqrt(1.0 / ac)),
        sqrt_recipm1_alphas_cumprod=dev(np.sqrt(1.0 / ac - 1.0)),
        posterior_variance=dev(post_var),
        posterior_log_variance_clipped=dev(post_log_var),
        posterior_mean_coef1=dev(betas * np.sqrt(ac_prev) / (1.0 - ac)),
        posterior_mean_coef2=dev((1.0 - ac_prev) * np.sqrt(alphas)
                                 / (1.0 - ac)),
    )


def extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-example coefficients broadcast to an ndim-rank tensor; negative
    t wraps."""
    out = arr[t].float()
    return out.reshape(out.shape + (1,) * (ndim - 1))
