"""Inference sampling loop (pass 1 of the CoMat step, and plain
text-to-image generation).

Port of comat_tpu/diffusion/sampler.py (`sample_inference`,
`prepare_latents`). Latents keep the JAX layout (B, h, w, 4). Randomness
comes from an explicit `torch.Generator`, or is injected as tensors
(`latents0`, and `step_noise` of shape (S, B, h, w, 4)) so that a test can
feed both ports the same draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from comat_tpu_torch.diffusion.schedulers import (
    SamplerCoeffs,
    ddpm_step_from_coeffs,
)


@torch.no_grad()
def sample_inference(
    eps_model: Callable,
    coeffs: SamplerCoeffs,
    latents0: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    step_noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run all S steps without gradients.

    `eps_model(x, t)` returns the guided eps. Each step's noise is
    `step_noise[i]` when given, else a standard normal draw from
    `generator`. Returns (final latents, eps table (S, B, h, w, 4),
    trajectory of step inputs (S, B, h, w, 4))."""
    S = len(coeffs.timesteps)
    if step_noise is not None and step_noise.shape[:1] != (S,):
        raise ValueError(
            f"step_noise has {step_noise.shape[0]} steps, the sampler {S}"
        )
    x = latents0
    eps_table, traj = [], []
    for i in range(S):
        eps = eps_model(x, int(coeffs.timesteps[i]))
        if step_noise is not None:
            noise = step_noise[i].to(device=x.device, dtype=torch.float32)
        else:
            noise = torch.randn(
                x.shape, generator=generator, device=x.device,
                dtype=torch.float32,
            )
        traj.append(x)
        eps_table.append(eps)
        x, _ = ddpm_step_from_coeffs(coeffs, i, x, eps, noise)
    return x, torch.stack(eps_table), torch.stack(traj)


def prepare_latents(
    generator: Optional[torch.Generator], batch: int, height: int, width: int,
    device: torch.device, channels: int = 4,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Initial noise (B, height/8, width/8, channels), pre-scaled by the
    DDPM init_noise_sigma of 1."""
    return torch.randn(
        (batch, height // 8, width // 8, channels), generator=generator,
        device=device, dtype=dtype,
    )
