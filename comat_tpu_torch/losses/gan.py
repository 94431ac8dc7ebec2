"""Fidelity preservation: the latent-space discriminator and its losses.

Port of comat_tpu/losses/gan.py (`GanConfig`, `DiscriminatorHead`,
`Discriminator`, `bce_with_logits`, `gan_g_loss`, `gan_d_loss`). The
discriminator (D) is a second SD UNet with its own LoRA and a small head:
a per-latent-pixel Linear(4 -> 1) in fp32 on the UNet's eps, or, with
`lastlayer_cls`, the UNet's conv_out narrowed to one channel. It scores
latents at the final inference timestep under the null-text condition.

- G side: BCE-with-logits of D(generated latents) against ones, added to
  the generator's loss. Its gradient flows through the latents into the
  sampler and never into D's tensors: `gan_g_loss` runs D with its
  trainable tensors set frozen, so autograd records no path to them.
- D side: the generated latents (detached) and the ground-truth latents
  of the batch, labels 0 and 1; only D's LoRA and head train.

`share_base_unet` makes D's frozen base the generator's own UNet tensors
(the same objects, not copies), as `trainer.py::_share_base_unet` makes
D's base the generator's pretrained weights. Under --full_finetuning the
generator's base trains, so D takes a frozen copy of it instead
(`copy_base`): JAX copies the values once at init, and the reference
loads a second UNet for D (gan_sd_model.py:8-13). An SDXL D (same
architecture as an SDXL generator) takes SDXL's added condition; a
cross-architecture D (`GanConfig.cross_arch`: the published SDXL recipe's
SD1.5-architecture D over SDXL latents) owns its own SD1.5 UNet, shares
nothing and takes no added condition.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

from comat_tpu_torch import trace
from comat_tpu_torch.config import UNetConfig
from comat_tpu_torch.models.lora import is_lora_path
from comat_tpu_torch.models.pipeline import resolve_device
from comat_tpu_torch.models.unet import UNet2DConditionModel
from comat_tpu_torch.weights import init_weights_


@dataclasses.dataclass(frozen=True)
class GanConfig:
    lora_rank: int = 32
    lastlayer_cls: bool = False     # --gan_unet_lastlayer_cls
    condition_discriminator: bool = False
    # --gan_model_arch of the other family than the generator's: D's text
    # condition is then CLIP-L's final states (768), not SDXL's concat
    cross_arch: bool = False


class DiscriminatorHead(nn.Module):
    """Linear(4 -> 1) over the channel axis, in fp32."""

    def __init__(self, device=None):
        super().__init__()
        self.mlp = nn.Linear(4, 1, dtype=torch.float32, device=device)

    def forward(self, eps: torch.Tensor) -> torch.Tensor:
        return self.mlp(eps)


class Discriminator(nn.Module):
    """D's UNet (`unet`) and head (`head`, None with `lastlayer_cls`).

    `base_unet`: a UNet whose non-LoRA tensors D takes as its own (the
    same Parameter objects) wherever name and shape agree, or with
    `copy_base` frozen copies of their values as they stand (a generator
    whose base trains, --full_finetuning); the other tensors (D's LoRA,
    the head, a one-channel conv_out) are allocated on `device` and drawn
    from `seed` (`weights.init_weights_`). Without `base_unet` every
    tensor is drawn from `seed`. Loading a state dict into a D that shares
    its base writes into the generator's tensors. `device`: CUDA unless
    the caller asks for the CPU (`models.pipeline.resolve_device`)."""

    def __init__(self, unet_cfg: UNetConfig, gan_cfg: GanConfig, device=None,
                 base_unet: Optional[nn.Module] = None, seed: int = 0,
                 copy_base: bool = False):
        super().__init__()
        self.gan_cfg = gan_cfg
        if gan_cfg.lastlayer_cls:
            unet_cfg = dataclasses.replace(unet_cfg, out_channels=1)
        device = resolve_device(device)
        with torch.device("meta"):
            self.unet = UNet2DConditionModel(unet_cfg, lora_rank=gan_cfg.lora_rank)
            self.head = None if gan_cfg.lastlayer_cls else DiscriminatorHead()
        shared = (share_base_unet(self.unet, base_unet, copy=copy_base)
                  if base_unet is not None else set())
        for name, p in list(self.named_parameters()):
            if name in shared:
                continue
            owner, leaf = self._owner(name)
            setattr(owner, leaf, nn.Parameter(
                torch.empty_like(p, device=device), requires_grad=False))
        self.eval()
        g = torch.Generator(device=device).manual_seed(seed)
        init_weights_(self, g, skip=shared)

    def _owner(self, name: str):
        *path, leaf = name.split(".")
        return self.get_submodule(".".join(path)), leaf

    def logits(self, latents: torch.Tensor, t, null_context: torch.Tensor,
               added_cond: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """(B, h, w, 1) classification logits at timestep t (`added_cond`:
        an SDXL D's)."""
        eps = self.unet(latents, t, null_context, added_cond)
        if self.head is None:
            return eps      # conv_out already emits one channel
        return self.head(eps.float())


def share_base_unet(unet: nn.Module, base: nn.Module, copy: bool = False) -> set:
    """Point every non-LoRA parameter of `unet` at `base`'s parameter of
    the same name and shape (the same object), or with `copy` at a frozen
    copy of its value. Returns the names taken, as `unet`'s parent
    `Discriminator` names them ("unet.<name>")."""
    base_params = dict(base.named_parameters())
    shared = set()
    for name, p in list(unet.named_parameters()):
        src = base_params.get(name)
        if is_lora_path(name) or src is None or src.shape != p.shape:
            continue
        if copy:
            src = nn.Parameter(src.detach().clone(), requires_grad=False)
        *path, leaf = name.split(".")
        setattr(unet.get_submodule(".".join(path)), leaf, src)
        shared.add(f"unet.{name}")
    return shared


@contextlib.contextmanager
def frozen(params: Iterable[torch.Tensor]) -> Iterator[None]:
    """Turn `requires_grad` off for those of `params` that have it inside
    the block, and back on after: autograd records no path to them."""
    params = [p for p in params if p.requires_grad]
    try:
        for p in params:
            p.requires_grad_(False)
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch BCEWithLogitsLoss (mean), written as JAX writes it:
    mean(softplus(x) - x*y) in fp32."""
    x = logits.float()
    return (F.softplus(x) - x * targets).mean()


def gan_g_loss(disc: Discriminator, gen_latents: torch.Tensor, t_final,
               null_context: torch.Tensor,
               added_cond: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Generator side: fool D toward "real". Differentiable with respect
    to `gen_latents` only."""
    with frozen(disc.parameters()):
        logits = disc.logits(gen_latents, t_final, null_context, added_cond)
    return bce_with_logits(logits, torch.ones_like(logits, dtype=torch.float32))


def gan_d_loss(disc: Discriminator, gen_latents: torch.Tensor,
               gt_latents: torch.Tensor, t_final,
               null_context: torch.Tensor,
               added_cond: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Discriminator side: generated latents 0, ground-truth latents 1."""
    gen = gen_latents.detach()
    with trace.sync("gan.gt_latents"):
        gt = gt_latents.to(gen.device, gen.dtype)
    lat = torch.cat([gen, gt], dim=0)
    B = gen.shape[0]
    ctx2 = torch.cat([null_context, null_context], dim=0)
    ac2 = None if added_cond is None else {
        k: torch.cat([v, v], dim=0) for k, v in added_cond.items()}
    logits = disc.logits(lat, t_final, ctx2, ac2)
    targets = torch.cat([torch.zeros_like(logits[:B], dtype=torch.float32),
                         torch.ones_like(logits[B:], dtype=torch.float32)])
    return bce_with_logits(logits, targets)
