"""The sampling loops: pass 1 (no gradient, also plain text-to-image
generation) and pass 2, the differentiable CoMat replay.

Port of comat_tpu/diffusion/sampler.py (`sample_inference`,
`_make_cached_primal_eps`, `sample_comat`, `prepare_latents`), without
attention capture. Latents keep the JAX layout (B, h, w, 4). Randomness
comes from an explicit `torch.Generator`, or is injected as tensors
(`latents0`, and `step_noise` of shape (S, B, h, w, 4)) so that a test can
feed both ports the same draws. One noise table serves pass 1 and the
replay, as `fold_in(rng, i)` does in JAX.

Gradients flow through the UNet only at the K trained steps. Pass 1 runs
all S steps without gradients and keeps each step's guided eps and input
latent. Pass 2 replays the K segments from the first trained step on:
each segment's UNet call is the cached-primal op (its forward returns
pass 1's eps, its backward re-runs the differentiable UNet at the same
point and returns the VJP), followed by `interval - 1` scheduler steps
with the saved eps, which are affine in the latent.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from comat_tpu_torch.diffusion.schedulers import (
    SamplerCoeffs,
    ddpm_step_from_coeffs,
)


class SampleResult(NamedTuple):
    latents: torch.Tensor       # (B, h, w, 4) final, differentiable
    eps_table: torch.Tensor     # (S, B, h, w, 4) guided eps of pass 1
    latents_traj: torch.Tensor  # (S, B, h, w, 4) pass-1 step inputs


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


class _CachedPrimalEps(torch.autograd.Function):
    """The guided eps at a trained step, as `_make_cached_primal_eps`.

    forward(diff_eps_model, t, x, cached_eps, context, null_context,
    *params) returns `cached_eps` (pass 1's eps at the same point) and
    runs no UNet. backward re-runs `diff_eps_model(x, t, context,
    null_context)` with gradients on and returns its VJP into x, the
    contexts and `params` (the trainable tensors the model reads), each
    only where autograd asks for it. The trainable tensors are inputs of
    the op, as `diff_tree` is in JAX, so their gradients reach them
    through autograd."""

    @staticmethod
    def forward(ctx, diff_eps_model, t, x, cached_eps, context, null_context,
                *params):
        ctx.diff_eps_model, ctx.t = diff_eps_model, t
        ctx.save_for_backward(x, context, null_context, *params)
        return cached_eps.clone()

    @staticmethod
    def backward(ctx, g):
        x, context, null_context, *params = ctx.saved_tensors
        need_x, need_c, need_n = ctx.needs_input_grad[2], *ctx.needs_input_grad[4:6]
        need_p = ctx.needs_input_grad[6:]
        with torch.enable_grad():
            xs = x.detach().requires_grad_(need_x)
            c = context.detach().requires_grad_(need_c)
            n = None if null_context is None else (
                null_context.detach().requires_grad_(need_n))
            eps = ctx.diff_eps_model(xs, ctx.t, c, n)
            wrt = [xs, c, n] + list(params)
            need = [need_x, need_c, need_n] + list(need_p)
            picked = [w for w, k in zip(wrt, need) if k]
            grads = iter(torch.autograd.grad(eps, picked, g, allow_unused=True))
        out = [next(grads) if k else None for k in need]
        return (None, None, out[0], None, out[1], out[2], *out[3:])


def sample_comat(
    diff_eps_model: Callable,
    coeffs: SamplerCoeffs,
    eps_table: torch.Tensor,
    latents_traj: torch.Tensor,
    step_noise: torch.Tensor,
    trained_idx: Sequence[int],
    interval: int,
    context: torch.Tensor,
    null_context: Optional[torch.Tensor],
    params: Sequence[torch.Tensor],
) -> torch.Tensor:
    """Pass 2 of the CoMat sampler: the differentiable replay from pass
    1's tables (`sample_inference`'s eps table and trajectory, made with
    the same `step_noise`). Returns the final latents, differentiable
    through the K trained steps only.

    `diff_eps_model(x, t, context, null_context)` is the differentiable
    guided eps, reading the trainable tensors `params`. `trained_idx`
    holds K ascending step indices, `interval` apart; the replay starts at
    pass 1's latent entering the first of them."""
    S = len(coeffs.timesteps)
    eps_table, latents_traj = eps_table.detach(), latents_traj.detach()
    trained: List[int] = [int(i) for i in trained_idx]
    x = latents_traj[trained[0]]
    for p in trained:
        t = int(coeffs.timesteps[p])
        eps = _CachedPrimalEps.apply(
            diff_eps_model, t, x, eps_table[p], context, null_context, *params
        )
        x, _ = ddpm_step_from_coeffs(coeffs, p, x, eps, step_noise[p])
        for pos in range(p + 1, min(p + interval, S)):
            x, _ = ddpm_step_from_coeffs(coeffs, pos, x, eps_table[pos],
                                         step_noise[pos])
    # positions after the last segment, when interval * K < S
    for pos in range(trained[-1] + interval, S):
        x, _ = ddpm_step_from_coeffs(coeffs, pos, x, eps_table[pos], step_noise[pos])
    return x


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
