"""Diffusion pipeline bundle: CLIP text encoder + UNet + VAE decoder +
sampler, for text-to-image generation.

Port of comat_tpu/models/pipeline.py (`PipelineConfig`,
`make_pipeline_config`, `DiffusionPipeline.encode_prompt / unet_apply /
decode_image / fused_unet / forward / presample / generate`) for SD1.5
and its tiny test geometry. The pipeline owns its modules and their
weights on one device: CUDA unless the caller asks for the CPU. Every
module is built frozen (`requires_grad` off); the train step marks the
trainable tensors (`training.train_step.partition_params`), and
`forward` differentiates with respect to those of the UNet; with
`capture=True` it also returns the cross-attention maps of the layers
`cfg.capture_layers` at the chosen replay segments (attribute
concentration). `forward(remat=)` and `DiffusionPipeline(fuse_pass1=False)`
are JAX's memory-tight options (--gradient_checkpointing). SDXL is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from comat_tpu_torch.config import CLIPTextConfig, UNetConfig, VAEConfig
from comat_tpu_torch.diffusion.guidance import make_cfg_eps_model
from comat_tpu_torch.diffusion.sampler import (
    SampleResult,
    prepare_latents,
    sample_comat,
    sample_inference,
)
from comat_tpu_torch.diffusion.schedulers import (
    DiffusionSchedule,
    make_sampler_coeffs,
    make_schedule,
    sample_dpmpp_2m,
)
from comat_tpu_torch.models.clip_text import CLIPTextEncoder
from comat_tpu_torch.models.lora import fuse_lora
from comat_tpu_torch.models.remat import Remat
from comat_tpu_torch.models.unet import UNet2DConditionModel
from comat_tpu_torch.models.vae import AutoencoderKL
from comat_tpu_torch.weights import init_weights_


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    unet: UNetConfig
    text: CLIPTextConfig
    vae: VAEConfig
    attrcon: bool = False
    capture_layers: Tuple[str, ...] = ()
    lora_rank: int = 32
    resolution: int = 512

    @property
    def latent_size(self) -> int:
        return self.resolution // 8


# The layers whose cross-attention maps attribute concentration reads
# (the reference's list for SD1.5, training_script.py:315), and their
# counterparts at the tiny geometry's resolutions.
SD15_CAPTURE = ("mid_8", "up_16", "up_32", "up_64")
TINY_CAPTURE = ("mid_2", "up_4", "up_8", "up_16")


def make_pipeline_config(
    name: str, lora_rank: int = 32, resolution: int = 512, tiny: bool = False,
) -> PipelineConfig:
    """`sd_1_5` and `sd_1_5_attrcon` at full or tiny width. A name with
    "attrcon" turns attribute concentration on (`attrcon`); either name
    carries the capture layer list, as in JAX."""
    if not name.startswith("sd_1_5"):
        raise ValueError(f"unknown or not yet ported pipeline {name!r}")
    kw = dict(attrcon="attrcon" in name, lora_rank=lora_rank,
              resolution=resolution)
    if tiny:
        return PipelineConfig(
            unet=UNetConfig.tiny(), text=CLIPTextConfig.tiny(),
            vae=VAEConfig.tiny(), capture_layers=TINY_CAPTURE, **kw,
        )
    return PipelineConfig(
        unet=UNetConfig.sd15(), text=CLIPTextConfig.sd15(),
        vae=VAEConfig.sd15(), capture_layers=SD15_CAPTURE, **kw,
    )


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless `device` says
    otherwise. Asking for CUDA without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


class EncodedPrompt(NamedTuple):
    context: torch.Tensor            # (B, L, D)
    pooled: Optional[torch.Tensor]   # SDXL only; None for SD1.5


def _build(module_fn, device: torch.device):
    """Build a module without initialising it, then allocate it on
    `device`; every parameter is written afterwards."""
    with torch.device("meta"):
        module = module_fn()
    return module.to_empty(device=device).eval().requires_grad_(False)


class _MasterView(torch.autograd.Function):
    """One use of a bf16 trained tensor, as JAX casts its fp32 leaf at
    each use. forward(master, working) returns a view of the bf16 working
    copy (no copy: `ClippedAdamW` keeps it equal to the master rounded);
    backward hands the bf16 cotangent to the fp32 master cast to fp32. A
    tensor used twice in a step (the text encoder on the prompts and on
    the null prompts) so sums its cotangents in fp32 at the master, as
    JAX sums them at its fp32 leaf, instead of in bf16 at the working
    copy."""

    @staticmethod
    def forward(ctx, master, working):
        return working.view_as(working)

    @staticmethod
    def backward(ctx, g):
        return g.float(), None


class DiffusionPipeline:
    """Modules and weights on one device.

    `params` is {"unet", "text", "vae"} state dicts (as `state_dicts()`
    returns or `weights.from_jax_params` makes); without it the weights
    are drawn from `seed` (`weights.init_weights_`).

    `fuse_pass1=False` (JAX's memory-tight flag, --gradient_checkpointing)
    builds no LoRA-free twin `unet_inf`: it would hold a second copy of
    every attention base weight for the life of the run. Pass 1 fuses
    exactly when the pipeline holds the twin; without it pass 1 runs the
    LoRA'd UNet, and `generate` samples with a twin made for the call
    (or the one its caller passes, see `fused_unet`)."""

    def __init__(
        self, cfg: PipelineConfig, device=None,
        params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        seed: int = 0, fuse_pass1: bool = True,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.unet = _build(
            lambda: UNet2DConditionModel(cfg.unet, lora_rank=cfg.lora_rank),
            self.device,
        )
        # LoRA-free twin for sampling, loaded by fused_unet()
        self.unet_inf = self.unet if cfg.lora_rank == 0 else (
            self._twin() if fuse_pass1 else None)
        self.text = _build(lambda: CLIPTextEncoder(cfg.text), self.device)
        self.vae = _build(lambda: AutoencoderKL(cfg.vae), self.device)
        self.schedule: DiffusionSchedule = make_schedule()
        # fp32 masters of bf16 trained tensors by name ("text.<name>",
        # "vae.<name>"), set by the train state (`set_masters`)
        self.masters: Dict[str, torch.Tensor] = {}
        if params is None:
            g = torch.Generator(device=self.device).manual_seed(seed)
            for module in (self.unet, self.text, self.vae):
                init_weights_(module, g)
        else:
            self.load_params(params)

    def load_params(self, params: Dict[str, Dict[str, torch.Tensor]]) -> None:
        self.unet.load_state_dict(params["unet"])
        self.text.load_state_dict(params["text"])
        self.vae.load_state_dict(params["vae"])

    def state_dicts(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {
            "unet": self.unet.state_dict(),
            "text": self.text.state_dict(),
            "vae": self.vae.state_dict(),
        }

    def _twin(self) -> torch.nn.Module:
        return _build(lambda: UNet2DConditionModel(self.cfg.unet, lora_rank=0),
                      self.device)

    def set_masters(self, masters: Mapping[str, torch.Tensor]) -> None:
        """fp32 masters of bf16 trained tensors by name ("text.<name>",
        "vae.<name>"): each use of such a tensor where autograd records
        runs on its own view (`_MasterView`), and its gradient lands on
        the master in fp32."""
        self.masters = dict(masters)

    def _tower(self, name: str, module: torch.nn.Module, *args, **kwargs):
        """module(*args, **kwargs), through master views where they apply."""
        pre = name + "."
        views = {n[len(pre):]: m for n, m in self.masters.items() if n.startswith(pre)}
        if not views or not torch.is_grad_enabled():
            return module(*args, **kwargs)
        own = dict(module.named_parameters())
        views = {n: _MasterView.apply(m, own[n].detach()) for n, m in views.items()}
        return torch.func.functional_call(module, views, args, kwargs)

    def _ids(self, ids) -> torch.Tensor:
        if not isinstance(ids, torch.Tensor):
            ids = torch.from_numpy(np.asarray(ids))
        return ids.to(self.device).long()

    # ---- text ----
    def encode_prompt(self, input_ids, eos_positions=None,
                      train_text_encoder: bool = False) -> EncodedPrompt:
        """SD1.5: the final-layer hidden states, with a gradient only for
        `train_text_encoder`."""
        eos = None if eos_positions is None else self._ids(eos_positions)
        with torch.set_grad_enabled(train_text_encoder and torch.is_grad_enabled()):
            hidden, _ = self._tower("text", self.text, self._ids(input_ids), eos)
        return EncodedPrompt(hidden, None)

    # ---- unet / vae ----
    def unet_apply(self, latents, t, context, fused: bool = False,
                   capture: bool = False, remat: Remat = False):
        """eps for latents (B, h, w, 4); with `capture`, (eps, maps of
        `cfg.capture_layers`). `fused=True` runs the LoRA-free twin, which
        must hold the fused weights (`fused_unet()` loads them). `remat`: block checkpointing
        (`UNet2DConditionModel.forward`)."""
        unet = self.unet_inf if fused else self.unet
        if capture:
            return unet(latents, t, context, capture=True,
                        capture_layers=self.cfg.capture_layers, remat=remat)
        return unet(latents, t, context, remat=remat)

    def decode_image(self, latents: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """latents (B, h, w, 4) -> image (B, 8h, 8w, 3) as
        decode / 2 + 0.5, unclamped; differentiable where autograd
        records. `remat` checkpoints each decoder resnet block."""
        img = self._tower("vae", self.vae, latents / self.cfg.vae.scaling_factor,
                          remat=remat)
        return img / 2.0 + 0.5

    def fused_unet(self) -> torch.nn.Module:
        """A LoRA-free UNet holding the weights with the LoRA folded in:
        the pipeline's twin, else one made for the caller, who may pass it
        to several `generate` calls while the weights stay as they are."""
        if self.cfg.lora_rank == 0:
            return self.unet
        unet = self.unet_inf if self.unet_inf is not None else self._twin()
        unet.load_state_dict(fuse_lora(self.unet.state_dict()))
        return unet

    def _pass1_unet(self) -> torch.nn.Module:
        """Pass 1's UNet: the fused twin where the pipeline holds one,
        else the LoRA'd UNet, its LoRA branch unfused."""
        return self.fused_unet() if self.unet_inf is not None else self.unet

    def _pass1_eps_model(self, context, null_context, guidance_scale,
                         guidance_rescale, unet: torch.nn.Module):
        """Pass 1's guided eps through `unet`, no gradients."""
        return make_cfg_eps_model(
            lambda lat, t, ctx: unet(lat, t, ctx),
            context.detach(),
            null_context.detach() if guidance_scale > 1.0 else None,
            guidance_scale,
            guidance_rescale,
        )

    # ---- the CoMat forward ----
    def forward(
        self,
        input_ids,
        null_ids,
        trained_idx: Sequence[int],
        *,
        num_inference_steps: int = 50,
        K: int = 5,
        guidance_scale: float = 7.5,
        guidance_rescale: float = 0.0,
        eos_positions=None,
        null_eos_positions=None,
        train_text_encoder: bool = False,
        latents0: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        presampled: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        capture: bool = False,
        capture_idx: Optional[Sequence[int]] = None,
        mark: Optional[Callable[[str], None]] = None,
        remat: Remat = False,
    ) -> Tuple[torch.Tensor, SampleResult]:
        """Differentiable online generation. Returns (image, result).

        image (B, H, W, 3) in [0, 1], unclamped, differentiable through the
        K trained steps and the VAE decode with respect to every UNet
        tensor that requires grad (the LoRA factors in the default
        recipe), the VAE's where they require grad, and the text
        encoder's under `train_text_encoder`. Pass 1 runs without
        gradients, on the fused LoRA-free twin where the pipeline holds one
        (else on the LoRA'd UNet, unfused); pass 2 replays the K segments with cached-primal
        UNet calls (`diffusion.sampler.sample_comat`).

        `remat` (JAX's `remat`: True, or an int R for the blocks at
        resolution >= R) checkpoints the UNet's blocks in the replay's
        recompute and, when set at all, each decoder resnet block. The
        capture forwards are not checkpointed, as in JAX.

        Randomness: `latents0` (B, h, w, 4) and `step_noise`
        (S, B, h, w, 4), one table for both passes, when given, else
        drawn from `generator` (latents first, then the table).
        `presampled=(eps_table, latents_traj)` skips pass 1 (see
        `presample`; give the same `step_noise`).

        `capture=True`: the cross-attention maps of `cfg.capture_layers`
        at the replay segments `capture_idx` (A indices into the K
        segments; default all K), in `result.captured`, key -> list of
        (A, B, heads, HW, 77) in the UNet's dtype. Each is a cond-half
        capture forward: batch B at the segment's entry latent and
        timestep, the prompt context, no guidance.

        `mark(name)` is called after pass 1 ("pass1"), after the replay
        ("replay"), after the capture forwards ("pass2"), around the
        backward of each replay and capture op (see `sample_comat`) and
        when the decode's backward ends ("decode_bwd>")."""
        cfg = self.cfg
        enc = self.encode_prompt(input_ids, eos_positions, train_text_encoder)
        nenc = self.encode_prompt(null_ids, null_eos_positions, train_text_encoder)
        B = enc.context.shape[0]
        coeffs = make_sampler_coeffs(self.schedule, num_inference_steps, kind="ddpm")
        if latents0 is None and presampled is None:
            latents0 = prepare_latents(generator, B, cfg.resolution,
                                       cfg.resolution, self.device)
        if step_noise is None:
            s = cfg.latent_size
            step_noise = torch.randn((num_inference_steps, B, s, s, 4),
                                     generator=generator, device=self.device)
        step_noise = step_noise.to(self.device, torch.float32)
        if presampled is None:
            _, eps_table, traj = sample_inference(
                self._pass1_eps_model(enc.context, nenc.context, guidance_scale,
                                      guidance_rescale, self._pass1_unet()),
                coeffs, latents0.to(self.device), step_noise=step_noise,
            )
        else:
            eps_table, traj = presampled
        if mark is not None:
            mark("pass1")

        def diff_eps_model(lat, t, context, null_context):
            return make_cfg_eps_model(
                lambda l, tt, ctx: self.unet_apply(l, tt, ctx, remat=remat),
                context, null_context, guidance_scale, guidance_rescale,
            )(lat, t)

        capture_primal = None
        if capture:
            cap_dtype = cfg.unet.dtype

            def capture_primal(lat, t, context):
                _, maps = self.unet_apply(lat, t, context, capture=True)
                return {key: [m.to(cap_dtype) for m in v] for key, v in maps.items()}

        result = sample_comat(
            diff_eps_model, coeffs, eps_table, traj, step_noise, trained_idx,
            num_inference_steps // K, enc.context,
            nenc.context if guidance_scale > 1.0 else None,
            [p for p in self.unet.parameters() if p.requires_grad],
            capture_primal=capture_primal, capture_idx=capture_idx, mark=mark,
        )
        latents = result.latents
        if mark is not None:
            mark("pass2")
            if latents.requires_grad:
                # autograd runs this view's node right after the decode's
                # backward: it marks that backward's end
                latents = latents.view_as(latents)
                latents.register_hook(lambda g: mark("decode_bwd>"))
        return self.decode_image(latents, remat=bool(remat)), result

    @torch.no_grad()
    def presample(
        self,
        input_ids,
        null_ids,
        *,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        guidance_rescale: float = 0.0,
        eos_positions=None,
        null_eos_positions=None,
        latents0: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        mark: Optional[Callable[[str], None]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Pass 1 alone, for callers that must see the image before the
        differentiable pass: returns (image, eps_table, latents_traj), the
        image unclamped; the tables go to `forward(presampled=...)` with the
        same `step_noise`. Pass 1 runs as in `forward`; `mark("pass1")` is
        called after it, before the decode."""
        enc = self.encode_prompt(input_ids, eos_positions)
        nenc = self.encode_prompt(null_ids, null_eos_positions)
        eps_model = self._pass1_eps_model(
            enc.context, nenc.context, guidance_scale, guidance_rescale,
            self._pass1_unet())
        if latents0 is None:
            latents0 = prepare_latents(
                generator, enc.context.shape[0], self.cfg.resolution,
                self.cfg.resolution, self.device,
            )
        if step_noise is not None:
            step_noise = step_noise.to(self.device, torch.float32)
        x, eps_table, traj = sample_inference(
            eps_model,
            make_sampler_coeffs(self.schedule, num_inference_steps, kind="ddpm"),
            latents0.to(self.device), generator, step_noise=step_noise,
        )
        if mark is not None:
            mark("pass1")
        return self.decode_image(x), eps_table, traj

    # ---- inference ----
    @torch.no_grad()
    def generate(
        self,
        input_ids,
        null_ids,
        *,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        guidance_rescale: float = 0.0,
        eos_positions=None,
        kind: str = "ddpm",
        output_type: str = "image",
        latents0: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        unet: Optional[torch.nn.Module] = None,
    ) -> torch.Tensor:
        """Text-to-image sampling without gradients.

        `kind`: "ddpm", "ddim", or "dpmpp" (DPM-Solver++ 2M,
        deterministic). Randomness: `latents0`
        (B, h, w, 4) and `step_noise` (S, B, h, w, 4) when given, else
        draws from `generator` (latents first, then one draw per step;
        DPM++ draws no noise). `unet`: the sampler, as `fused_unet()`
        returns it (default: `fused_unet()` for this call). Returns images
        (B, H, W, 3) clipped to [0, 1], or the final latents for
        `output_type="latent"`."""
        if kind not in ("ddpm", "ddim", "dpmpp"):
            raise ValueError(f"unknown scheduler {kind!r} (ddpm, ddim, dpmpp)")
        cfg = self.cfg
        enc = self.encode_prompt(input_ids, eos_positions)
        nenc = self.encode_prompt(null_ids, None)
        B = enc.context.shape[0]
        eps_model = self._pass1_eps_model(
            enc.context, nenc.context, guidance_scale, guidance_rescale,
            unet if unet is not None else self.fused_unet())
        if latents0 is None:
            latents0 = prepare_latents(
                generator, B, cfg.resolution, cfg.resolution, self.device
            )
        if kind == "dpmpp":
            latents = sample_dpmpp_2m(eps_model, self.schedule, num_inference_steps,
                                      latents0.to(self.device))
        else:
            coeffs = make_sampler_coeffs(self.schedule, num_inference_steps, kind=kind)
            latents, _, _ = sample_inference(
                eps_model, coeffs, latents0.to(self.device), generator,
                step_noise=step_noise,
            )
        if output_type == "latent":
            return latents
        return self.decode_image(latents).clamp(0.0, 1.0)
