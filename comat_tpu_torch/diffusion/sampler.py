"""The sampling loops: pass 1 (no gradient, also plain text-to-image
generation) and pass 2, the differentiable CoMat replay.

Port of comat_tpu/diffusion/sampler.py (`sample_inference`,
`_make_cached_primal_eps`, `_make_capture_only`, `sample_comat`,
`prepare_latents`). Latents keep the JAX layout (B, h, w, 4). Randomness
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
with the saved eps, which are affine in the latent. With capture
(attribute concentration), A capture-only ops then run at the entry
latents of the A chosen segments: each computes the cond-half
cross-attention maps, and its backward re-runs that forward with
gradients on.

SDXL's added condition: the pooled text embeds (the prompts' and the
null prompts') are inputs of both ops beside the contexts, so their
gradients reach the second text tower as JAX's `diff_tree["added"]`
carries them; the size and crop ids ride in the eps models and capture
primals the pipeline passes, constants of the op.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from comat_tpu_torch import trace
from comat_tpu_torch.diffusion.schedulers import (
    SamplerCoeffs,
    ddpm_step_from_coeffs,
)


class SampleResult(NamedTuple):
    latents: torch.Tensor       # (B, h, w, 4) final, differentiable
    captured: Dict[str, List[torch.Tensor]]  # key -> [(A, B, heads, HW, 77)]
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

    `eps_model(x, t)` returns the guided eps, `t` step i's timestep as a
    0-dim int64 tensor on the latents' device: the S timesteps are
    uploaded once (the sync "sampler.timesteps"), and no call waits on an
    upload of its own. The eps it returns may be a buffer that the next
    call overwrites (a CUDA graph's output, `diffusion/pass1_graph.py`):
    each is copied into the table at once. Each step's noise is
    `step_noise[i]` when given, else a standard normal draw from
    `generator`. Returns (final latents, eps table (S, B, h, w, 4),
    trajectory of step inputs (S, B, h, w, 4)). Each guided call is a span
    "unet" on the active clock, with the mark "unet>" at its end
    (`comat_tpu_torch.trace`)."""
    S = len(coeffs.timesteps)
    if step_noise is not None and step_noise.shape[:1] != (S,):
        raise ValueError(
            f"step_noise has {step_noise.shape[0]} steps, the sampler {S}"
        )
    x = latents0
    with trace.sync("sampler.timesteps"):
        timesteps = torch.tensor(coeffs.timesteps, dtype=torch.long, device=x.device)
    traj = x.new_empty((S, *x.shape))
    eps_table = None
    for i in range(S):
        with trace.span("unet"):
            eps = eps_model(x, timesteps[i])
            trace.mark("unet>")
        if eps_table is None:
            eps_table = eps.new_empty((S, *eps.shape))
        eps_table[i].copy_(eps)
        traj[i].copy_(x)
        if step_noise is not None:
            noise = step_noise[i].to(device=x.device, dtype=torch.float32)
        else:
            noise = torch.randn(
                x.shape, generator=generator, device=x.device,
                dtype=torch.float32,
            )
        x, _ = ddpm_step_from_coeffs(coeffs, i, x, eps_table[i], noise)
    return x, eps_table, traj


class _CachedPrimalEps(torch.autograd.Function):
    """The guided eps at a trained step, as `_make_cached_primal_eps`.

    forward(diff_eps_model, t, n_cond, x, cached_eps, *conds, *params)
    returns `cached_eps` (pass 1's eps at the same point) and
    runs no UNet. `conds` are the `n_cond` conditioning tensors the model
    takes after (x, t), each possibly None: the context and the null
    context, and with SDXL the pooled text embeds of the prompts and of
    the null prompts. backward re-runs `diff_eps_model(x, t, *conds)`
    with gradients on and returns its VJP into x, the conds and `params`
    (the trainable tensors the model reads, or the fp32 masters it reads
    them through), each only where autograd asks for it. The conds and
    the trainable tensors are inputs of the op, as `diff_tree` is in JAX,
    so their gradients reach them through autograd."""

    @staticmethod
    def forward(ctx, diff_eps_model, t, n_cond, x, cached_eps, *inputs):
        ctx.diff_eps_model, ctx.t, ctx.n_cond = diff_eps_model, t, n_cond
        ctx.save_for_backward(x, *inputs)
        return cached_eps.clone()

    @staticmethod
    def backward(ctx, g):
        x, *inputs = ctx.saved_tensors
        n = ctx.n_cond
        need = [ctx.needs_input_grad[3], *ctx.needs_input_grad[5:]]
        trace.mark("replay_bwd<")
        with torch.enable_grad():
            xs = x.detach().requires_grad_(need[0])
            conds = [None if c is None else c.detach().requires_grad_(k)
                     for c, k in zip(inputs[:n], need[1:])]
            eps = ctx.diff_eps_model(xs, ctx.t, *conds)
            wrt = [xs, *conds, *inputs[n:]]
            picked = [w for w, k in zip(wrt, need) if k]
            grads = iter(torch.autograd.grad(eps, picked, g, allow_unused=True))
        out = [next(grads) if k else None for k in need]
        trace.mark("replay_bwd>")
        return (None, None, None, out[0], None, *out[1:])


class _CaptureOnly(torch.autograd.Function):
    """The captured maps at one attribute-concentration segment, as
    `_make_capture_only`.

    forward(capture_primal, t, layout, n_cond, x, *conds, *params)
    runs `capture_primal(x, t, *conds)` -> {key: [maps]} (the cond-half
    capture forward, batch B, no guidance; `conds` the context and, with
    SDXL, the prompts' pooled text embeds) without gradients and returns
    its maps flattened in key order; `layout` receives the (key, count)
    pairs to rebuild the dict. backward re-runs the same forward with
    gradients on and returns its VJP into x, the conds and `params`,
    where autograd asks for them. Nothing is kept across calls but the
    inputs: the backward recomputes its own residuals."""

    @staticmethod
    def forward(ctx, capture_primal, t, layout, n_cond, x, *inputs):
        ctx.capture_primal, ctx.t, ctx.n_cond = capture_primal, t, n_cond
        ctx.save_for_backward(x, *inputs)
        maps = capture_primal(x, t, *inputs[:n_cond])
        layout[:] = [(key, len(v)) for key, v in maps.items()]
        return tuple(m for v in maps.values() for m in v)

    @staticmethod
    def backward(ctx, *gs):
        x, *inputs = ctx.saved_tensors
        n = ctx.n_cond
        need = list(ctx.needs_input_grad[4:])
        trace.mark("capture_bwd<")
        with torch.enable_grad():
            xs = x.detach().requires_grad_(need[0])
            conds = [None if c is None else c.detach().requires_grad_(k)
                     for c, k in zip(inputs[:n], need[1:])]
            maps = ctx.capture_primal(xs, ctx.t, *conds)
            outs = [m for v in maps.values() for m in v]
            used = [(o, g) for o, g in zip(outs, gs) if g is not None]
            picked = [w for w, k in zip([xs, *conds, *inputs[n:]], need) if k]
            grads = iter(torch.autograd.grad(
                [o for o, _ in used], picked, [g for _, g in used],
                allow_unused=True))
        out = [next(grads) if k else None for k in need]
        trace.mark("capture_bwd>")
        return (None, None, None, None, *out)


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
    capture_primal: Optional[Callable] = None,
    capture_idx: Optional[Sequence[int]] = None,
    pooled: Optional[torch.Tensor] = None,
    null_pooled: Optional[torch.Tensor] = None,
) -> SampleResult:
    """Pass 2 of the CoMat sampler: the differentiable replay from pass
    1's tables (`sample_inference`'s eps table and trajectory, made with
    the same `step_noise`). Returns a SampleResult whose final latents
    are differentiable through the K trained steps only.

    `diff_eps_model(x, t, context, null_context)` is the differentiable
    guided eps, reading the trainable tensors `params`; with SDXL's
    `pooled` text embeds (and `null_pooled`, the null prompts', None
    without guidance) `diff_eps_model(x, t, context, null_context, pooled,
    null_pooled)`, which carries their gradients as the contexts'. `trained_idx`
    holds K ascending step indices, `interval` apart; the replay starts at
    pass 1's latent entering the first of them.

    With `capture_primal(x, t, context) -> {key: [maps]}` (with
    `pooled`, `capture_primal(x, t, context, pooled)`), the maps are
    captured at the segments `capture_idx` (A indices into the K
    segments, repeats allowed; default all K), each at its segment's entry
    latent and timestep, and returned in `captured`, each map stacked over
    A. On the active clock (`comat_tpu_torch.trace`) the replay and the
    captures are the spans "replay" and "capture", marked after each
    replay segment ("replay_op>"), after the replay ("replay"), after each
    capture op ("capture_op>") and around each op's backward
    ("replay_bwd<", "replay_bwd>", "capture_bwd<", "capture_bwd>")."""
    S = len(coeffs.timesteps)
    eps_table, latents_traj = eps_table.detach(), latents_traj.detach()
    trained: List[int] = [int(i) for i in trained_idx]
    conds = [context, null_context] + ([pooled, null_pooled] if pooled is not None else [])
    cap_conds = [context] + ([pooled] if pooled is not None else [])
    x = latents_traj[trained[0]]
    entries = []
    with trace.span("replay"):
        for p in trained:
            t = int(coeffs.timesteps[p])
            entries.append(x)
            eps = _CachedPrimalEps.apply(
                diff_eps_model, t, len(conds), x, eps_table[p], *conds, *params
            )
            x, _ = ddpm_step_from_coeffs(coeffs, p, x, eps, step_noise[p])
            for pos in range(p + 1, min(p + interval, S)):
                x, _ = ddpm_step_from_coeffs(coeffs, pos, x, eps_table[pos],
                                             step_noise[pos])
            trace.mark("replay_op>")
        # positions after the last segment, when interval * K < S
        for pos in range(trained[-1] + interval, S):
            x, _ = ddpm_step_from_coeffs(coeffs, pos, x, eps_table[pos], step_noise[pos])
    trace.mark("replay")

    captured: Dict[str, List[torch.Tensor]] = {}
    if capture_primal is not None:
        idx = range(len(trained)) if capture_idx is None else capture_idx
        caps = []
        with trace.span("capture"):
            for seg in (int(i) for i in idx):
                layout: List[Tuple[str, int]] = []
                flat = iter(_CaptureOnly.apply(
                    capture_primal, int(coeffs.timesteps[trained[seg]]), layout,
                    len(cap_conds), entries[seg], *cap_conds, *params))
                caps.append({key: [next(flat) for _ in range(n)] for key, n in layout})
                trace.mark("capture_op>")
        if caps:
            captured = {key: [torch.stack([c[key][i] for c in caps])
                              for i in range(len(maps))]
                        for key, maps in caps[0].items()}
    return SampleResult(x, captured, eps_table, latents_traj)


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
