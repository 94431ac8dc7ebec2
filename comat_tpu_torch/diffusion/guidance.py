"""Classifier-free guidance as an eps-model wrapper.

Port of comat_tpu/diffusion/guidance.py (`rescale_noise_cfg`,
`make_cfg_eps_model`, without attention capture). With guidance, the
UNet runs once on the [uncond; cond] 2B batch, uncond first, and the
halves are recombined, optionally with guidance rescale (arXiv
2305.08891 §3.4). SDXL's added condition is concatenated the same way,
null first, key by key.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def rescale_noise_cfg(
    noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
    guidance_rescale: float,
) -> torch.Tensor:
    dims = tuple(range(1, noise_cfg.dim()))
    std_text = noise_pred_text.float().std(dim=dims, keepdim=True, unbiased=False)
    std_cfg = noise_cfg.float().std(dim=dims, keepdim=True, unbiased=False)
    rescaled = noise_cfg * (std_text / std_cfg).to(noise_cfg.dtype)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


class GuidedEps:
    """eps_model(latents, t) -> guided eps, as `make_cfg_eps_model` makes it.

    `context` holds the UNet's context: [null; cond] (2B) under guidance,
    else the prompts' (B); `added` SDXL's added condition the same way
    (None without it). `apply` runs the call on conditions given in their
    place, laid out as these (a CUDA graph's static buffers,
    `diffusion/pass1_graph.py`)."""

    def __init__(self, unet_apply: Callable, context: torch.Tensor,
                 added: Optional[Dict[str, torch.Tensor]], guided: bool,
                 guidance_scale: float, guidance_rescale: float):
        self.unet_apply = unet_apply
        self.context, self.added = context, added
        self.guided = guided
        self.guidance_scale, self.guidance_rescale = guidance_scale, guidance_rescale

    def __call__(self, latents: torch.Tensor, t) -> torch.Tensor:
        return self.apply(latents, t, self.context, self.added)

    def apply(self, latents: torch.Tensor, t, context: torch.Tensor,
              added: Optional[Dict[str, torch.Tensor]]) -> torch.Tensor:
        extra = () if added is None else (added,)
        if not self.guided:
            return self.unet_apply(latents, t, context, *extra)
        B = latents.shape[0]
        eps2 = self.unet_apply(torch.cat([latents, latents], dim=0), t, context, *extra)
        eps_uncond, eps_text = eps2[:B], eps2[B:]
        eps = eps_uncond + self.guidance_scale * (eps_text - eps_uncond)
        if self.guidance_rescale > 0.0:
            eps = rescale_noise_cfg(eps, eps_text, self.guidance_rescale)
        return eps


def make_cfg_eps_model(
    unet_apply: Callable,
    context: torch.Tensor,
    null_context: Optional[torch.Tensor],
    guidance_scale: float,
    guidance_rescale: float = 0.0,
    added_cond: Optional[Dict[str, torch.Tensor]] = None,
    null_added_cond: Optional[Dict[str, torch.Tensor]] = None,
) -> GuidedEps:
    """Returns eps_model(latents, t) -> guided eps.

    `unet_apply(latents, t, context)` -> eps, or with `added_cond` (SDXL)
    `unet_apply(latents, t, context, added_cond)`. `null_context=None` or
    `guidance_scale <= 1` turns guidance off. `null_added_cond` defaults
    to `added_cond`, as in JAX."""
    do_cfg = null_context is not None and guidance_scale > 1.0
    added = added_cond
    if added_cond is not None and do_cfg:
        nac = added_cond if null_added_cond is None else null_added_cond
        added = {k: torch.cat([nac[k], added_cond[k]], dim=0) for k in added_cond}
    ctx = torch.cat([null_context, context], dim=0) if do_cfg else context
    return GuidedEps(unet_apply, ctx, added, do_cfg, guidance_scale, guidance_rescale)
