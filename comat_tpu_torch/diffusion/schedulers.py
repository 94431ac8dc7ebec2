"""Noise schedule, affine sampler steps (DDPM fixed_small, DDIM) and the
DPM-Solver++ 2M sampler.

Port of comat_tpu/diffusion/schedulers.py, `v_to_eps` included. The tables are numpy: the
schedule is computed in fp64 and kept in fp32, the per-step coefficients
are computed in fp64 from those fp32 tables and kept in fp32, exactly as
the JAX package does, so both ports step with identical coefficients.
Every sampler step is the affine update

    prev = coef_sample[i] * x + coef_eps[i] * eps + sigma[i] * noise

with the arithmetic in fp32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class DiffusionSchedule(NamedTuple):
    """Training-time noise schedule tables (length num_train_timesteps)."""

    betas: np.ndarray            # (T,) float32
    alphas_cumprod: np.ndarray   # (T,) float32
    num_train_timesteps: int


def make_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
) -> DiffusionSchedule:
    """Beta/alpha tables; `scaled_linear` is the SD1.5 schedule."""
    if beta_schedule == "scaled_linear":
        betas = np.linspace(
            beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
            dtype=np.float64,
        ) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(
            beta_start, beta_end, num_train_timesteps, dtype=np.float64
        )
    else:
        raise ValueError(f"unknown beta_schedule {beta_schedule!r}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    return DiffusionSchedule(
        betas=betas.astype(np.float32),
        alphas_cumprod=alphas_cumprod.astype(np.float32),
        num_train_timesteps=num_train_timesteps,
    )


def inference_timesteps(
    num_inference_steps: int,
    num_train_timesteps: int = 1000,
    steps_offset: int = 1,
    timestep_spacing: str = "leading",
) -> np.ndarray:
    """Descending inference timesteps, diffusers "leading" spacing with
    steps_offset=1 (50 steps -> [981, 961, ..., 1]) or "trailing"."""
    if timestep_spacing == "leading":
        step_ratio = num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]
        ts = ts.astype(np.int64) + steps_offset
    elif timestep_spacing == "trailing":
        step_ratio = num_train_timesteps / num_inference_steps
        ts = np.round(np.arange(num_train_timesteps, 0, -step_ratio)).astype(
            np.int64
        )
        ts -= 1
    else:
        raise ValueError(f"unknown timestep_spacing {timestep_spacing!r}")
    return ts.astype(np.int32)


class SamplerCoeffs(NamedTuple):
    """Per-inference-step affine coefficients, all (S,) float32 numpy;
    `timesteps` (S,) int32 descending.

        prev_x  = coef_sample[i] * x + coef_eps[i] * eps + sigma[i] * noise
        pred_x0 = x0_from_sample[i] * x + x0_from_eps[i] * eps
    """

    timesteps: np.ndarray
    coef_sample: np.ndarray
    coef_eps: np.ndarray
    sigma: np.ndarray
    x0_from_sample: np.ndarray
    x0_from_eps: np.ndarray
    sqrt_alpha_prod: np.ndarray
    sqrt_one_minus_alpha_prod: np.ndarray


def make_sampler_coeffs(
    schedule: DiffusionSchedule,
    num_inference_steps: int,
    kind: str = "ddpm",
    eta: float = 0.0,
    steps_offset: int = 1,
    timestep_spacing: str = "leading",
) -> SamplerCoeffs:
    """Affine step table for `kind` in {"ddpm", "ddim"}: DDPM with
    fixed_small variance, epsilon prediction and no clipping; DDIM with
    the deterministic update at eta=0."""
    T = schedule.num_train_timesteps
    acp = np.asarray(schedule.alphas_cumprod, dtype=np.float64)
    ts = inference_timesteps(
        num_inference_steps, T, steps_offset, timestep_spacing
    )
    step_ratio = T // num_inference_steps
    prev_ts = ts - step_ratio

    alpha_prod_t = acp[ts]
    alpha_prod_prev = np.where(prev_ts >= 0, acp[np.maximum(prev_ts, 0)], 1.0)
    beta_prod_t = 1.0 - alpha_prod_t
    current_alpha_t = alpha_prod_t / alpha_prod_prev
    current_beta_t = 1.0 - current_alpha_t

    x0_from_sample = 1.0 / np.sqrt(alpha_prod_t)
    x0_from_eps = -np.sqrt(beta_prod_t) / np.sqrt(alpha_prod_t)

    if kind == "ddpm":
        coef_x0 = np.sqrt(alpha_prod_prev) * current_beta_t / beta_prod_t
        coef_x = np.sqrt(current_alpha_t) * (1.0 - alpha_prod_prev) / beta_prod_t
        coef_sample = coef_x0 * x0_from_sample + coef_x
        coef_eps = coef_x0 * x0_from_eps
        variance = (1.0 - alpha_prod_prev) / (1.0 - alpha_prod_t) * current_beta_t
        variance = np.clip(variance, 1e-20, None)
        sigma = np.where(ts > 0, np.sqrt(variance), 0.0)
    elif kind == "ddim":
        sigma_ddim = eta * np.sqrt(
            (1.0 - alpha_prod_prev)
            / (1.0 - alpha_prod_t)
            * (1.0 - alpha_prod_t / alpha_prod_prev)
        )
        dir_coef = np.sqrt(np.maximum(1.0 - alpha_prod_prev - sigma_ddim**2, 0.0))
        coef_sample = np.sqrt(alpha_prod_prev) * x0_from_sample
        coef_eps = np.sqrt(alpha_prod_prev) * x0_from_eps + dir_coef
        sigma = sigma_ddim
    else:
        raise ValueError(f"unknown sampler kind {kind!r}")

    def f32(a):
        return np.asarray(a, dtype=np.float32)

    return SamplerCoeffs(
        timesteps=ts.astype(np.int32),
        coef_sample=f32(coef_sample),
        coef_eps=f32(coef_eps),
        sigma=f32(sigma),
        x0_from_sample=f32(x0_from_sample),
        x0_from_eps=f32(x0_from_eps),
        sqrt_alpha_prod=f32(np.sqrt(alpha_prod_t)),
        sqrt_one_minus_alpha_prod=f32(np.sqrt(beta_prod_t)),
    )


def ddpm_step_from_coeffs(
    coeffs: SamplerCoeffs,
    i: int,
    sample: torch.Tensor,
    eps: torch.Tensor,
    noise: torch.Tensor,
):
    """One affine sampler step at inference-step index `i`. Returns
    (prev_sample, pred_x0), computed in fp32 and cast back to the sample
    dtype."""
    x = sample.float()
    e = eps.float()
    prev = (
        float(coeffs.coef_sample[i]) * x
        + float(coeffs.coef_eps[i]) * e
        + float(coeffs.sigma[i]) * noise.float()
    )
    pred_x0 = float(coeffs.x0_from_sample[i]) * x + float(coeffs.x0_from_eps[i]) * e
    return prev.to(sample.dtype), pred_x0.to(sample.dtype)


def v_to_eps(schedule: DiffusionSchedule, t, sample: torch.Tensor,
             v: torch.Tensor, acp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A v-prediction output as epsilon at timestep t (an int, or a tensor
    of one or one a sample), JAX's `v_to_eps` (--prediction_type
    v_prediction): eps = a v + s x with a = sqrt(acp_t), s = sqrt(1 -
    acp_t), in fp32, cast to v's dtype. diffusers' v branch computes x0 =
    a x - s v, which the eps branch gives exactly from this eps, so every
    eps-based table applies. `acp`: the schedule's `alphas_cumprod` already
    on the sample's device, read there without an upload (a timestep
    tensor on that device included), so that the call can be captured in
    a CUDA graph; uploaded here when None."""
    if acp is None:
        acp = torch.as_tensor(schedule.alphas_cumprod, device=sample.device)
    if isinstance(t, (int, np.integer)):
        acp = acp[int(t)]
    else:
        # take, not acp[t]: a 0-dim index tensor would be read on the host
        acp = torch.take(acp, torch.as_tensor(t, device=acp.device).long())
    while acp.dim() < sample.dim():
        acp = acp[..., None]
    out = torch.sqrt(acp) * v.float() + torch.sqrt(1.0 - acp) * sample.float()
    return out.to(v.dtype)


def sample_dpmpp_2m(
    eps_model,
    schedule: DiffusionSchedule,
    num_inference_steps: int,
    latents0: torch.Tensor,
    steps_offset: int = 1,
) -> torch.Tensor:
    """DPM-Solver++ 2M sampling (deterministic), JAX's `sample_dpmpp_2m`:
    algorithm "dpmsolver++", solver order 2, epsilon prediction, the
    validation scheduler of the reference. `eps_model(x, t)` returns the
    guided eps. Data-prediction updates

        x_{i+1} = (s_{i+1}/s_i) x - a_{i+1} (e^{-h} - 1) D

    with D = x0_i at the first step and the 2M correction
    D = x0_i + (x0_i - x0_{i-1}) / (2 r) after; the last step returns
    x0 (alpha -> 1, sigma -> 0). alpha, sigma and lambda are computed in
    fp64 and kept in fp32, and the scalar arithmetic is fp32, as in JAX."""
    acp = np.asarray(schedule.alphas_cumprod, dtype=np.float64)
    ts = inference_timesteps(num_inference_steps, schedule.num_train_timesteps,
                             steps_offset)
    alpha = np.sqrt(acp[ts]).astype(np.float32)
    sigma = np.sqrt(1.0 - acp[ts]).astype(np.float32)
    lam = (np.log(np.sqrt(acp[ts])) - np.log(np.sqrt(1.0 - acp[ts]))).astype(np.float32)
    S = len(ts)
    x = latents0.float()
    x0_prev = None
    for i in range(S):
        eps = eps_model(x, int(ts[i])).float()
        x0 = (x - float(sigma[i]) * eps) / float(alpha[i])
        if i == S - 1:
            x = x0
            break
        h = lam[i + 1] - lam[i]
        d = x0
        if x0_prev is not None:
            r = (lam[i] - lam[i - 1]) / h
            d = x0 + (x0 - x0_prev) / float(np.float32(2.0) * r)
        x = (float(sigma[i + 1] / sigma[i]) * x
             - float(alpha[i + 1] * (np.exp(-h) - np.float32(1.0))) * d)
        x0_prev = x0
    return x.to(latents0.dtype)
