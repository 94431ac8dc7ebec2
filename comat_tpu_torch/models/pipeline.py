"""Diffusion pipeline bundle: CLIP text encoder(s) + UNet + VAE decoder +
sampler, for text-to-image generation.

Port of comat_tpu/models/pipeline.py (`PipelineConfig`,
`make_pipeline_config`, `DiffusionPipeline.encode_prompt /
sdxl_added_cond / unet_apply / decode_image / fused_unet / forward /
presample / generate`) for SD1.5 and SDXL and their tiny test geometries.
SDXL runs two text towers (CLIP-L and OpenCLIP bigG, `text2`), reads
the penultimate states of both, concatenated, and conditions the UNet on
the projected pooled output of the second and the six size and crop ids
(`sdxl_added_cond`), guided null first like the context. The pooled
embeds enter the replay and the capture ops as inputs beside the
contexts, so a trained second tower (`text2`) gets their gradient, as
JAX's `diff_tree["added"]` carries it. With `text_lora_rank > 0`
(--train_text_encoder_lora) both text towers carry LoRA on their
attention projections. The pipeline owns its modules and their
weights on one device: CUDA unless the caller asks for the CPU. Every
module is built frozen (`requires_grad` off); the train step marks the
trainable tensors (`training.train_step.partition_params`), and
`forward` differentiates with respect to those of the UNet (through
their fp32 masters where `set_masters` gave them: --full_finetuning of
the bf16 UNet); with
`capture=True` it also returns the cross-attention maps of the layers
`cfg.capture_layers` at the chosen replay segments (attribute
concentration). `forward(remat=)` and `DiffusionPipeline(fuse_pass1=False)`
are JAX's memory-tight options (--gradient_checkpointing);
`forward(pass1_int8=)` / `presample(pass1_int8=)` / `generate(int8=)` run
the no-grad sampling in W8A8 (--pass1_int8, models/quant.py), and
`cfg.prediction_type="v_prediction"` converts every UNet output the
samplers and the replay read from v to eps (JAX's `unet_apply`). On a
card, pass 1's guided call (`forward`, `presample`, `generate`) replays
the pipeline's one CUDA graph where its input allows
(`diffusion/pass1_graph.py`, `DiffusionPipeline.pass1_graph`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from comat_tpu_torch import trace
from comat_tpu_torch.config import CLIPTextConfig, UNetConfig, VAEConfig
from comat_tpu_torch.diffusion.guidance import make_cfg_eps_model
from comat_tpu_torch.diffusion.pass1_graph import GraphedEps, Pass1Graph
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
    v_to_eps,
)
from comat_tpu_torch.models.clip_text import CLIPTextEncoder
from comat_tpu_torch.models.lora import fuse_lora, is_lora_path
from comat_tpu_torch.models.quant import pass1_w8a8
from comat_tpu_torch.models.remat import Remat
from comat_tpu_torch.models.unet import UNet2DConditionModel
from comat_tpu_torch.models.vae import AutoencoderKL
from comat_tpu_torch.weights import init_weights_


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    unet: UNetConfig
    text: CLIPTextConfig
    vae: VAEConfig
    text2: Optional[CLIPTextConfig] = None   # SDXL's second text tower
    is_sdxl: bool = False
    attrcon: bool = False
    capture_layers: Tuple[str, ...] = ()
    lora_rank: int = 32
    resolution: int = 512
    # --train_text_encoder_lora: the text towers' LoRA rank (JAX's
    # `text_lora_rank`; the trainer passes --lora_rank)
    text_lora_rank: int = 0
    # --prediction_type: "epsilon", or "v_prediction", converted to eps at
    # every UNet output the samplers and the replay read (`unet_apply`, pass 1)
    prediction_type: str = "epsilon"

    @property
    def latent_size(self) -> int:
        return self.resolution // 8


# The layers whose cross-attention maps attribute concentration reads
# (the reference's list for SD1.5, training_script.py:315), and their
# counterparts at the tiny geometry's resolutions.
SD15_CAPTURE = ("mid_8", "up_16", "up_32", "up_64")
TINY_CAPTURE = ("mid_2", "up_4", "up_8", "up_16")
# SDXL's list (training_script.py:312) and its tiny counterpart
SDXL_CAPTURE = ("mid_16", "up_16", "up_32")
TINY_XL_CAPTURE = ("mid_4", "up_4", "up_8")


def make_pipeline_config(
    name: str, lora_rank: int = 32, resolution: int = 512, tiny: bool = False,
    text_lora_rank: int = 0, prediction_type: str = "epsilon",
) -> PipelineConfig:
    """`sd_1_5*` and `sdxl*` (sdxl, sdxl_unet, sdxl_attrcon,
    sdxl_attrcon_unet) at full or tiny width. A name with "attrcon" turns
    attribute concentration on (`attrcon`); every name carries its
    family's capture layer list, as in JAX. The tiny SDXL UNet's context
    is the two tiny towers' concatenation (32 + 32), as the real one's is
    768 + 1280. `text_lora_rank`: LoRA on both text towers (0: none).
    `prediction_type`: "epsilon" or "v_prediction"; anything else raises,
    as in JAX (a typo would train a v-model in epsilon mode)."""
    if prediction_type not in ("epsilon", "v_prediction"):
        raise ValueError(f"prediction_type must be 'epsilon' or 'v_prediction', "
                         f"got {prediction_type!r}")
    kw = dict(attrcon="attrcon" in name, lora_rank=lora_rank,
              resolution=resolution, text_lora_rank=text_lora_rank,
              prediction_type=prediction_type)
    if name.startswith("sdxl"):
        if tiny:
            return PipelineConfig(
                unet=UNetConfig.tiny_xl(cross_attention_dim=64),
                text=CLIPTextConfig.tiny(), vae=VAEConfig.tiny(),
                text2=CLIPTextConfig.tiny(), is_sdxl=True,
                capture_layers=TINY_XL_CAPTURE, **kw,
            )
        return PipelineConfig(
            unet=UNetConfig.sdxl(), text=CLIPTextConfig.sd15(), vae=VAEConfig.sdxl(),
            text2=CLIPTextConfig.sdxl_big_g(), is_sdxl=True,
            capture_layers=SDXL_CAPTURE, **kw,
        )
    if not name.startswith("sd_1_5"):
        raise ValueError(f"unknown pipeline {name!r}")
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
    pooled: Optional[torch.Tensor]   # (B, Dp) SDXL only; None for SD1.5


AddedCond = Optional[Dict[str, torch.Tensor]]


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

    `params` is {"unet", "text", "vae"} state dicts, and "text2" for
    SDXL (as `state_dicts()` returns or `weights.from_jax_params` makes);
    without it the weights are drawn from `seed` (`weights.init_weights_`):
    the towers first, then the UNet's LoRA factors, then the text towers',
    so that a seed gives the towers the same weights at every LoRA rank and
    the UNet's factors the same at every text-LoRA rank
    (`hf_import.load_sd_state` loads a diffusers snapshot over them).

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
        self.text = _build(lambda: CLIPTextEncoder(cfg.text, lora_rank=cfg.text_lora_rank),
                           self.device)
        self.vae = _build(lambda: AutoencoderKL(cfg.vae), self.device)
        self.text2 = None if cfg.text2 is None else _build(
            lambda: CLIPTextEncoder(cfg.text2, lora_rank=cfg.text_lora_rank), self.device)
        self.schedule: DiffusionSchedule = make_schedule()
        self._acp: Dict[torch.device, torch.Tensor] = {}   # alphas_cumprod by device
        # pass 1's guided call as one CUDA graph (diffusion/pass1_graph.py)
        self.pass1_graph = Pass1Graph()
        # fp32 masters of bf16 trained tensors by name ("unet.<name>",
        # "text.<name>", "vae.<name>"), set by the train state (`set_masters`)
        self.masters: Dict[str, torch.Tensor] = {}
        if params is None:
            g = torch.Generator(device=self.device).manual_seed(seed)
            towers = self._towers()
            lora = {name: {n for n, _ in m.named_parameters() if is_lora_path(n)}
                    for name, m in towers.items()}
            for name, module in towers.items():
                init_weights_(module, g, skip=lora[name])
            for name in ("unet", "text", "text2"):
                if lora.get(name):
                    module = towers[name]
                    init_weights_(module, g, skip=set(module.state_dict()) - lora[name])
        else:
            self.load_params(params)

    def _towers(self) -> Dict[str, torch.nn.Module]:
        towers = {"unet": self.unet, "text": self.text, "vae": self.vae}
        if self.text2 is not None:
            towers["text2"] = self.text2
        return towers

    def load_params(self, params: Dict[str, Dict[str, torch.Tensor]]) -> None:
        for name, module in self._towers().items():
            module.load_state_dict(params[name])

    def state_dicts(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: module.state_dict() for name, module in self._towers().items()}

    def _twin(self) -> torch.nn.Module:
        return _build(lambda: UNet2DConditionModel(self.cfg.unet, lora_rank=0),
                      self.device)

    def set_masters(self, masters: Mapping[str, torch.Tensor]) -> None:
        """fp32 masters of bf16 trained tensors by name ("unet.<name>",
        "text.<name>", "text2.<name>", "vae.<name>"): each use of such a
        tensor where autograd records runs on its own view (`_MasterView`),
        and its gradient lands on the master in fp32. The replay and the
        capture ops take the UNet's masters as their inputs, so the K
        segments' and the A captures' gradients sum in fp32 there."""
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
        with trace.sync("pipeline.ids"):
            return ids.to(self.device).long()

    # ---- text ----
    def encode_prompt(self, input_ids, eos_positions=None,
                      train_text_encoder: bool = False,
                      input_ids2=None) -> EncodedPrompt:
        """SD1.5: the final-layer hidden states. SDXL: the penultimate
        states of both towers, concatenated, and the projected pooled
        output of the second, taken at `eos_positions` (S - 1 when None);
        tower 2 reads `input_ids2` (the pad-id-0 tokenizer's ids), else
        `input_ids`. A gradient only for `train_text_encoder`."""
        eos = None if eos_positions is None else self._ids(eos_positions)
        with torch.set_grad_enabled(train_text_encoder and torch.is_grad_enabled()):
            if not self.cfg.is_sdxl:
                hidden, _ = self._tower("text", self.text, self._ids(input_ids), eos)
                return EncodedPrompt(hidden, None)
            h1, _ = self._tower("text", self.text, self._ids(input_ids), eos,
                                output_hidden_state_skip=1)
            ids2 = input_ids if input_ids2 is None else input_ids2
            h2, pooled = self._tower("text2", self.text2, self._ids(ids2), eos,
                                     output_hidden_state_skip=1)
        return EncodedPrompt(torch.cat([h1, h2], dim=-1), pooled)

    def sdxl_added_cond(self, pooled: torch.Tensor, batch: int) -> Dict[str, torch.Tensor]:
        """SDXL's added condition: {"text_embeds": pooled, "time_ids"
        (B, 6) fp32: original size, crop top-left, target size}, the sizes
        the resolution and the crop (0, 0), as every caller of JAX's
        `sdxl_added_cond` takes them (reference TrainableSDPipeline.py:428-449)."""
        r = self.cfg.resolution
        time_ids = torch.tensor([[r, r, 0, 0, r, r]], dtype=torch.float32,
                                device=pooled.device)
        return {"text_embeds": pooled, "time_ids": time_ids.expand(batch, 6)}

    def _encode_pair(self, input_ids, null_ids, eos_positions, null_eos_positions,
                     input_ids2, null_ids2, train_text_encoder: bool = False):
        """The prompts' and the null prompts' encodings, and with SDXL their
        added conditions (else None), as JAX's forward makes them: the null
        prompts' tower 2 reads `null_ids2`, else `null_ids`."""
        # input_ids2 only where given: the SD1.5 call keeps its three arguments
        kw = {} if input_ids2 is None else {"input_ids2": input_ids2}
        nkw = {} if null_ids2 is None else {"input_ids2": null_ids2}
        enc = self.encode_prompt(input_ids, eos_positions, train_text_encoder, **kw)
        nenc = self.encode_prompt(null_ids, null_eos_positions, train_text_encoder,
                                  **nkw)
        added = null_added = None
        if self.cfg.is_sdxl:
            B = enc.context.shape[0]
            added = self.sdxl_added_cond(enc.pooled, B)
            null_added = self.sdxl_added_cond(nenc.pooled, B)
        return enc, nenc, added, null_added

    # ---- unet / vae ----
    def unet_apply(self, latents, t, context, added_cond: AddedCond = None,
                   fused: bool = False, capture: bool = False, remat: Remat = False):
        """eps for latents (B, h, w, 4); with `capture`, (eps, maps of
        `cfg.capture_layers`). `added_cond`: SDXL's (`sdxl_added_cond`).
        `fused=True` runs the LoRA-free twin, which must hold the fused
        weights (`fused_unet()` loads them). `remat`: block checkpointing
        (`UNet2DConditionModel.forward`). The LoRA'd UNet runs through the
        fp32 masters of its trained bf16 tensors where autograd records
        (`set_masters`). A v-prediction model's output is converted to eps
        (`_as_eps`)."""
        kw = dict(capture=True, capture_layers=self.cfg.capture_layers) if capture else {}
        if fused:
            out = self.unet_inf(latents, t, context, added_cond, remat=remat, **kw)
        else:
            out = self._tower("unet", self.unet, latents, t, context, added_cond,
                              remat=remat, **kw)
        if capture:
            return self._as_eps(out[0], t, latents), out[1]
        return self._as_eps(out, t, latents)

    def _as_eps(self, out: torch.Tensor, t, latents: torch.Tensor) -> torch.Tensor:
        """The UNet's output at (latents, t) as eps: v converted under
        `prediction_type="v_prediction"` (JAX's `unet_apply`), else as is."""
        if self.cfg.prediction_type == "v_prediction":
            return v_to_eps(self.schedule, t, latents, out,
                            self._alphas_cumprod(latents.device))
        return out

    def _alphas_cumprod(self, device: torch.device) -> torch.Tensor:
        """The schedule's `alphas_cumprod` on `device`, uploaded once."""
        if device not in self._acp:
            with trace.sync("schedule.alphas_cumprod"):
                self._acp[device] = torch.as_tensor(self.schedule.alphas_cumprod,
                                                    device=device)
        return self._acp[device]

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
                         guidance_rescale, unet: torch.nn.Module,
                         added: AddedCond = None,
                         null_added: AddedCond = None) -> GraphedEps:
        """Pass 1's guided eps through `unet`, no gradients (v converted
        to eps, as `unet_apply` does), replayed from the pipeline's CUDA
        graph where the call allows one (`diffusion/pass1_graph.py`)."""
        detach = lambda ac: None if ac is None else {  # noqa: E731
            k: v.detach() for k, v in ac.items()}
        eager = make_cfg_eps_model(
            lambda lat, t, ctx, *ac: self._as_eps(unet(lat, t, ctx, *ac), t, lat),
            context.detach(),
            null_context.detach() if guidance_scale > 1.0 else None,
            guidance_scale,
            guidance_rescale,
            detach(added), detach(null_added),
        )
        return self.pass1_graph.eps_model(eager, unet, self.cfg.prediction_type)

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
        input_ids2=None,
        null_ids2=None,
        train_text_encoder: bool = False,
        latents0: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        presampled: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        capture: bool = False,
        capture_idx: Optional[Sequence[int]] = None,
        remat: Remat = False,
        pass1_int8: bool = False,
    ) -> Tuple[torch.Tensor, SampleResult]:
        """Differentiable online generation. Returns (image, result).

        image (B, H, W, 3) in [0, 1], unclamped, differentiable through the
        K trained steps and the VAE decode with respect to every UNet
        tensor that requires grad (the LoRA factors in the default
        recipe, the whole UNet under --full_finetuning, through its fp32
        masters), the VAE's where they require grad, and the text
        towers' under `train_text_encoder` (with SDXL both, the second
        through the pooled embeds too). SDXL: tower 2
        reads `input_ids2` / `null_ids2` where given (else `input_ids` /
        `null_ids`), and the null prompts' pooled embed is taken at
        `null_eos_positions`, S - 1 when None, as in JAX. Pass 1 runs without
        gradients, on the fused LoRA-free twin where the pipeline holds one
        (else on the LoRA'd UNet, unfused); pass 2 replays the K segments with cached-primal
        UNet calls (`diffusion.sampler.sample_comat`). `pass1_int8`
        (--pass1_int8) runs pass 1 alone in W8A8 (models/quant.py): that
        UNet's weights, fused or the base beside the unfused LoRA, are
        quantized once here and freed after pass 1; the replay and the
        capture run the layers' own dtype.

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

        On the active clock (`comat_tpu_torch.trace`) pass 1 and the
        decode are the spans "pass1" and "decode", marked after pass 1
        ("pass1"), after the replay ("replay"), after the capture forwards
        ("pass2"), around the backward of each replay and capture op (see
        `sample_comat`) and when the decode's backward ends
        ("decode_bwd>")."""
        cfg = self.cfg
        enc, nenc, added, null_added = self._encode_pair(
            input_ids, null_ids, eos_positions, null_eos_positions, input_ids2,
            null_ids2, train_text_encoder)
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
            unet = self._pass1_unet()
            with pass1_w8a8(unet, pass1_int8), trace.span("pass1"):
                _, eps_table, traj = sample_inference(
                    self._pass1_eps_model(enc.context, nenc.context, guidance_scale,
                                          guidance_rescale, unet, added, null_added),
                    coeffs, latents0.to(self.device), step_noise=step_noise,
                )
        else:
            eps_table, traj = presampled
        trace.mark("pass1")

        guided = guidance_scale > 1.0
        # SDXL: the pooled embeds are the ops' inputs, the size ids constants
        pooled = null_pooled = None
        if added is not None:
            pooled = added["text_embeds"]
            null_pooled = null_added["text_embeds"] if guided else None

        def with_pooled(ac: AddedCond, p):
            return None if ac is None or p is None else {**ac, "text_embeds": p}

        def diff_eps_model(lat, t, context, null_context, p=None, null_p=None):
            return make_cfg_eps_model(
                lambda l, tt, ctx, *ac: self.unet_apply(l, tt, ctx, *ac, remat=remat),
                context, null_context, guidance_scale, guidance_rescale,
                with_pooled(added, p), with_pooled(null_added, null_p),
            )(lat, t)

        capture_primal = None
        if capture:
            cap_dtype = cfg.unet.dtype

            def capture_primal(lat, t, context, p=None):
                _, maps = self.unet_apply(lat, t, context, with_pooled(added, p),
                                          capture=True)
                return {key: [m.to(cap_dtype) for m in v] for key, v in maps.items()}

        # the trained UNet tensors, each through its fp32 master where it has one
        params = [self.masters.get(f"unet.{n}", p)
                  for n, p in self.unet.named_parameters() if p.requires_grad]
        result = sample_comat(
            diff_eps_model, coeffs, eps_table, traj, step_noise, trained_idx,
            num_inference_steps // K, enc.context, nenc.context if guided else None,
            params, capture_primal=capture_primal, capture_idx=capture_idx,
            pooled=pooled, null_pooled=null_pooled,
        )
        latents = result.latents
        trace.mark("pass2")
        if trace.current() is not None and latents.requires_grad:
            # autograd runs this view's node right after the decode's
            # backward: it marks that backward's end
            latents = latents.view_as(latents)
            latents.register_hook(lambda g: trace.mark("decode_bwd>"))
        with trace.span("decode"):
            image = self.decode_image(latents, remat=bool(remat))
        return image, result

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
        input_ids2=None,
        null_ids2=None,
        latents0: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        pass1_int8: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Pass 1 alone, for callers that must see the image before the
        differentiable pass: returns (image, eps_table, latents_traj), the
        image unclamped; the tables go to `forward(presampled=...)` with the
        same `step_noise`. Pass 1 runs as in `forward` (`pass1_int8` too).
        On the active clock pass 1 and the decode are the spans "pass1"
        and "presample.decode", with the mark "presample_pass1" between
        them."""
        enc, nenc, added, null_added = self._encode_pair(
            input_ids, null_ids, eos_positions, null_eos_positions, input_ids2,
            null_ids2)
        unet = self._pass1_unet()
        eps_model = self._pass1_eps_model(
            enc.context, nenc.context, guidance_scale, guidance_rescale,
            unet, added, null_added)
        if latents0 is None:
            latents0 = prepare_latents(
                generator, enc.context.shape[0], self.cfg.resolution,
                self.cfg.resolution, self.device,
            )
        if step_noise is not None:
            step_noise = step_noise.to(self.device, torch.float32)
        with pass1_w8a8(unet, pass1_int8), trace.span("pass1"):
            x, eps_table, traj = sample_inference(
                eps_model,
                make_sampler_coeffs(self.schedule, num_inference_steps, kind="ddpm"),
                latents0.to(self.device), generator, step_noise=step_noise,
            )
        trace.mark("presample_pass1")
        with trace.span("presample.decode"):
            image = self.decode_image(x)
        return image, eps_table, traj

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
        input_ids2=None,
        null_ids2=None,
        kind: str = "ddpm",
        output_type: str = "image",
        latents0: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        unet: Optional[torch.nn.Module] = None,
        int8: bool = False,
    ) -> torch.Tensor:
        """Text-to-image sampling without gradients.

        `kind`: "ddpm", "ddim", or "dpmpp" (DPM-Solver++ 2M,
        deterministic). Randomness: `latents0`
        (B, h, w, 4) and `step_noise` (S, B, h, w, 4) when given, else
        draws from `generator` (latents first, then one draw per step;
        DPM++ draws no noise). `unet`: the sampler, as `fused_unet()`
        returns it (default: `fused_unet()` for this call). SDXL: tower 2
        reads `input_ids2` / `null_ids2` where given, and the null prompts'
        pooled embed is taken at S - 1. `int8`: sample in W8A8, the
        sampler's weights quantized for this call (JAX's `generate(int8=)`).
        Returns images
        (B, H, W, 3) clipped to [0, 1], or the final latents for
        `output_type="latent"`."""
        if kind not in ("ddpm", "ddim", "dpmpp"):
            raise ValueError(f"unknown scheduler {kind!r} (ddpm, ddim, dpmpp)")
        cfg = self.cfg
        enc, nenc, added, null_added = self._encode_pair(
            input_ids, null_ids, eos_positions, None, input_ids2, null_ids2)
        B = enc.context.shape[0]
        own_twin = unet is None and self.unet_inf is None and self.cfg.lora_rank > 0
        unet = unet if unet is not None else self.fused_unet()
        eps_model = self._pass1_eps_model(
            enc.context, nenc.context, guidance_scale, guidance_rescale,
            unet, added, null_added)
        if latents0 is None:
            latents0 = prepare_latents(
                generator, B, cfg.resolution, cfg.resolution, self.device
            )
        with pass1_w8a8(unet, int8):
            if kind == "dpmpp":
                latents = sample_dpmpp_2m(eps_model, self.schedule, num_inference_steps,
                                          latents0.to(self.device))
            else:
                coeffs = make_sampler_coeffs(self.schedule, num_inference_steps, kind=kind)
                latents, _, _ = sample_inference(
                    eps_model, coeffs, latents0.to(self.device), generator,
                    step_noise=step_noise,
                )
        if own_twin and self.pass1_graph.holds(unet):
            self.pass1_graph.release()      # nothing else holds this call's twin
        if output_type == "latent":
            return latents
        return self.decode_image(latents).clamp(0.0, 1.0)
