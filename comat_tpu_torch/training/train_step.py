"""The CoMat train step: the concept-matching (BLIP) reward, the latent
GAN and attribute concentration.

Port of comat_tpu/training/train_step.py (`TrainConfig`, `DiscState`,
`partition_params`, `partition_disc_params`, `make_optimizer`,
`make_d_optimizer`, `init_disc_state`, `sample_trained_idx`,
`make_loss_fn`, `make_train_step`, `make_presample`), every flag of it
ported: `pass1_int8` runs pass 1 (and a split step's presample) in W8A8
(models/quant.py). The trainable surface is JAX's: the LoRA factors (the UNet's, and the text
towers' at `text_lora_rank > 0`), the whole UNet under
`full_finetuning`, the VAE and both text towers with `tune_vae` /
`tune_text_encoder`; `use_8bit_adam` keeps AdamW's moments as int8
blocks (`training.optim8bit`). `gradient_accumulation_steps` N > 1 accumulates the
generator's gradients in its optimizer and applies their mean every N-th
step, as JAX's `optax.MultiSteps` does (`ClippedAdamW`); D updates every
step. One step: encode the prompts, pass 1 (50
no-grad CFG UNet calls with LoRA fused; unfused under
`gradient_checkpointing`, which also checkpoints the UNet's blocks in the
replay's recompute and the decoder's resnet blocks), pass 2 (the
K cached-primal replay segments, and with attribute concentration the
capture forwards at A of them), VAE decode with gradient, crop jitter,
the BLIP caption loss and the reward-gradient tap, the GAN's G loss
(`disc`), the grounding losses (`extra_losses`, see training/attrcon.py),
backward, a global-norm clip and AdamW on the trainable tensors; then,
with a D optimizer, the discriminator's update on the detached latents
and the batch's `gt_latents`.

`make_presample` is the no-grad presample of the split step that an
image-dependent segmenter (Grounded-SAM) needs: pass 1 and the decode
first, the masks of its image, then the step replaying pass 1's tables.

Randomness is injected: a `StepDraws` holds the initial latents, the
per-step noise table (S, B, h, w, 4), the K-schedule start, the crop
offsets and the A attribute-concentration draws; `sample_draws` makes
one from a `torch.Generator`.

The reward-gradient tap (reference training_script.py:644-651): only the
caption reward backpropagates through the decoded image, so one BLIP
forward and backward at the cropped image gives both the image-gradient
norm (`reward_norm`, and the `norm_grad` rescale) and the loss gradient,
reattached to the image as <sg(g * factor), cropped - sg(cropped)>.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from comat_tpu_torch import trace
from comat_tpu_torch.diffusion import pass1_graph
from comat_tpu_torch.diffusion.schedulers import inference_timesteps
from comat_tpu_torch.losses.caption_reward import (
    IGNORE_INDEX,
    blip_caption_reward,
    crop_jitter,
)
from comat_tpu_torch.losses.gan import Discriminator, gan_d_loss, gan_g_loss
from comat_tpu_torch.models.lora import is_lora_path
from comat_tpu_torch.models.pipeline import DiffusionPipeline
from comat_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads,
    gather_metrics,
    grad_norm,
    local_rows,
    sum_over_data,
)
from comat_tpu_torch.trace import PhaseClock
from comat_tpu_torch.training.optim8bit import AdamW8bit


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The flags of the reference that reach the step (defaults:
    scripts/sd15.sh)."""

    total_step: int = 50            # --total_step (denoising steps)
    K: int = 5                      # --K (trained steps)
    guidance_scale: float = 7.5     # --cfg_scale
    guidance_rescale: float = 0.0   # --cfg_rescale
    resolution: int = 512
    reward_weight: float = 1.0      # --reward_weights[0] ('Blip')
    learning_rate: float = 5e-5
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    adam_weight_decay: float = 1e-2
    max_grad_norm: float = 0.1
    norm_grad: bool = False         # --norm_grad
    train_text_encoder: bool = False
    gan_loss: bool = False
    gan_loss_weight: float = 1.0    # --gan_loss_weight
    attrcon: bool = False
    attrcon_train_steps: int = 2    # --attrcon_train_steps (A)
    mask_token_loss_weight: float = 1e-3
    mask_pixel_loss_weight: float = 5e-5
    gradient_accumulation_steps: int = 1
    use_8bit_adam: bool = False     # --use_8bit_adam
    # --gradient_checkpointing: block remat (UNet in the replay, decoder)
    # and pass 1 unfused (no LoRA-free twin)
    gradient_checkpointing: bool = False
    # --remat_min_res R: remat only the UNet blocks at resolution >= R
    # (and every decoder block); pass 1 stays fused unless the flag above
    remat_min_res: Optional[int] = None
    # --pass1_int8: W8A8 dynamic quantization of pass 1's 50 no-grad UNet
    # calls (the replay, the capture and D stay in the layers' dtype)
    pass1_int8: bool = False
    textenc_lr: Optional[float] = None   # --textenc_lora_lr

    @property
    def interval(self) -> int:
        return self.total_step // self.K


def partition_params(
    pipeline: DiffusionPipeline,
    tune_vae: bool = False,
    tune_text_encoder: bool = False,
    full_finetuning: bool = False,
) -> Dict[str, torch.nn.Parameter]:
    """Mark the trainable tensors of the pipeline and return them by name
    ("unet.<name>", "vae.<name>", "text.<name>", "text2.<name>"): every
    LoRA factor (the UNet's, and the text towers' where they carry LoRA),
    the whole UNet (base and LoRA) with `full_finetuning`, the whole VAE
    (encoder and decoder, as JAX marks its `vae` subtree) with `tune_vae`
    and both text towers with `tune_text_encoder` (JAX's ("text",
    "text2")). Every other parameter is set frozen (`requires_grad` off).
    The encoder gets no gradient (the step only decodes), so AdamW's
    weight decay alone moves it, as in JAX.

    A tensor of a bf16 tower stays bf16 here, the module's working copy;
    the optimizer keeps its fp32 master (`ClippedAdamW`)."""
    towers = [("unet", pipeline.unet), ("text", pipeline.text), ("vae", pipeline.vae)]
    if pipeline.text2 is not None:
        towers.append(("text2", pipeline.text2))
    marks = [
        (f"{tower}.{name}", p, is_lora_path(name)
         or (full_finetuning and tower == "unet")
         or (tune_vae and tower == "vae")
         or (tune_text_encoder and tower in ("text", "text2")))
        for tower, module in towers
        for name, p in module.named_parameters()
    ]
    for _, p, train in marks:
        p.requires_grad_(train)
    return {name: p for name, p, train in marks if train}


def _is_text(name: str) -> bool:
    """A text tower's tensor ("text.<name>", "text2.<name>"): JAX's "text"
    label of the --textenc_lora_lr group."""
    return name.split(".", 1)[0] in ("text", "text2")


class ClippedAdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(...)) over named
    tensors, with a second AdamW group for the text towers' tensors when
    `textenc_lr` is set (the clip stays joint, as in JAX). With
    `cfg.use_8bit_adam` AdamW is JAX's `adamw_8bit`
    (`training.optim8bit.AdamW8bit`: int8 blockwise moments) in both
    groups.

    The clip and AdamW act on fp32 master weights, `masters` by name. An
    fp32 tensor (the LoRA factors, the VAE's fp32 `conv_out`) is its own
    master. A bf16 tensor is the module's working copy of an fp32 master:
    taken from `initial_masters` where it names the tensor (the fp32
    values the weights were rounded from), else the tensor upcast. Its
    bf16 gradient is cast to fp32 for the clip and AdamW, and after each
    step the master, rounded to bf16, is written into the working copy.
    That is the arithmetic of JAX's fp32 Flax parameter under a bf16
    module: the module casts the fp32 leaf to bf16 (the working copy),
    the cast's VJP turns the bf16 cotangent into an fp32 gradient, optax
    updates the fp32 leaf, and the next forward casts it again. A bf16
    tensor's master requires grad: the pipeline runs each use of the
    tensor on its own view of the working copy whose backward hands the
    cotangent to the master in fp32 (`DiffusionPipeline.set_masters`), so
    two uses in a step (the text encoder on the prompts and on the null
    prompts) sum in fp32, as in JAX. A gradient on the working copy
    itself (a caller that ran the module directly) is cast and added.

    `lr_schedule(count)` -> learning rate, evaluated before each update
    at the number of updates done (optax's `count`); the text group then
    takes it times textenc_lr / learning_rate, as JAX's `make_optimizer`
    does. Without it the learning rates are constant.

    `cfg.gradient_accumulation_steps` N > 1 is JAX's
    `optax.MultiSteps(chain(clip, adamw), every_k_schedule=N)`: each step
    folds its fp32 gradients into the running mean `acc` (acc += (g -
    acc) / (k + 1) at micro-step k) and leaves the tensors as they are
    (no weight decay either); the N-th clips the mean, applies AdamW and
    zeroes `acc`. `count`, the schedule's argument and AdamW's bias
    correction advance only on applying steps, as MultiSteps' inner state
    does; `mini_step` counts the micro-steps since the last one.

    The clip is written as optax writes it: gradients are left as they are
    when their global norm is below `max_norm`, else divided by the norm
    and multiplied by `max_norm` (no epsilon, unlike
    `torch.nn.utils.clip_grad_norm_`). A trainable tensor without a
    gradient gets a zero one, so that weight decay reaches it as in optax.
    AdamW itself is `torch.optim.AdamW`: the same update as optax.adamw
    (bias-corrected moments, eps outside the square root, decoupled weight
    decay scaled by the learning rate); the 8-bit one follows
    `optim8bit`."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: TrainConfig,
                 initial_masters: Optional[Mapping[str, torch.Tensor]] = None,
                 lr_schedule: Optional[Callable[[int], float]] = None):
        self.params = params
        self.max_norm = cfg.max_grad_norm
        self.lr_schedule = lr_schedule
        self.count = 0
        self.every = max(1, cfg.gradient_accumulation_steps)
        self.mini_step = 0
        self.acc: Dict[str, torch.Tensor] = {}
        initial_masters = initial_masters or {}
        self.masters: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for name, p in params.items():
                if p.dtype == torch.float32:
                    self.masters[name] = p
                    continue
                src = initial_masters.get(name, p)
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"master of {name}: shape {tuple(src.shape)}, "
                                     f"tensor {tuple(p.shape)}")
                master = src.detach().to(p.device, torch.float32, copy=True)
                p.copy_(master)
                self.masters[name] = master.requires_grad_()
        main = [m for n, m in self.masters.items() if not _is_text(n)]
        text = [m for n, m in self.masters.items() if _is_text(n)]
        groups = [{"params": main, "lr": cfg.learning_rate}]
        if text:
            groups.append({"params": text, "lr": cfg.textenc_lr
                           if cfg.textenc_lr is not None else cfg.learning_rate})
        groups = [g for g in groups if g["params"]]
        # each group's rate as a fraction of the schedule's
        self._ratios = [g["lr"] / cfg.learning_rate if cfg.learning_rate else 0.0
                        for g in groups]
        adamw = AdamW8bit if cfg.use_8bit_adam else torch.optim.AdamW
        self.adam = adamw(
            groups, lr=cfg.learning_rate,
            betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
            weight_decay=cfg.adam_weight_decay,
        )

    def zero_grad(self) -> None:
        for name, p in self.params.items():
            p.grad = None
            self.masters[name].grad = None

    @torch.no_grad()
    def step(self, reduce: Optional[Callable[[List[torch.Tensor]], None]] = None,
             norm: Optional[Callable[[Dict[str, torch.Tensor]], torch.Tensor]] = None,
             ) -> torch.Tensor:
        """Clip and apply the gradients in `.grad` (under accumulation,
        fold them into the mean and apply that on every N-th call); returns
        the global norm of the gradients in `.grad` (a 0-dim fp32 tensor),
        before any clip. The working copies' own `.grad` are left as the
        backward wrote them.

        `reduce(grads)`, where given, sums the fp32 gradients in place over
        the data-parallel ranks before anything reads them
        (`parallel.mesh.all_reduce_grads`); `norm(grads by name)` replaces
        the local global norm (`parallel.mesh.grad_norm`, which counts a
        tensor-parallel shard's squares across its model group)."""
        for name, p in self.params.items():
            master = self.masters[name]
            if master is not p and p.grad is not None:
                g = p.grad.float()
                master.grad = g if master.grad is None else master.grad + g
            if master.grad is None:
                master.grad = torch.zeros_like(master)
        if reduce is not None:
            reduce([m.grad for m in self.masters.values()])
        if norm is None:
            def norm(named):
                return torch.stack([g.square().sum() for g in named.values()]).sum().sqrt()
        grads = [m.grad for m in self.masters.values()]
        norm_before = norm({n: m.grad for n, m in self.masters.items()})
        if self.every > 1:
            k = self.mini_step
            for name, m in self.masters.items():
                acc = self.acc.get(name)
                if acc is None:
                    acc = self.acc[name] = torch.zeros_like(m.grad)
                acc.add_((m.grad - acc) / (k + 1))
            if k < self.every - 1:
                self.mini_step += 1
                return norm_before
            self.mini_step = 0
            for name, m in self.masters.items():
                m.grad = self.acc[name].clone()
                self.acc[name].zero_()
            grads = [m.grad for m in self.masters.values()]
            clip_norm = norm({n: m.grad for n, m in self.masters.items()})
        else:
            clip_norm = norm_before
        with trace.sync("clip_norm"):
            clip = float(clip_norm) >= self.max_norm
        if clip:
            for g in grads:
                g.div_(clip_norm).mul_(self.max_norm)
        if self.lr_schedule is not None:
            lr = float(self.lr_schedule(self.count))
            for group, ratio in zip(self.adam.param_groups, self._ratios):
                group["lr"] = lr * ratio
        self.adam.step()
        self.count += 1
        for name, p in self.params.items():
            if self.masters[name] is not p:
                p.copy_(self.masters[name])
        return norm_before

    def state_dict(self) -> Dict[str, object]:
        """The update count, the fp32 masters of bf16 tensors and AdamW's
        state (moments and steps; the 8-bit codes and scales with
        `use_8bit_adam`), for a checkpoint; under accumulation also the
        micro-step counter and the running mean."""
        state = {"count": self.count, "adam": self.adam.state_dict(),
                 "masters": {n: m.detach() for n, m in self.masters.items()
                             if m is not self.params[n]}}
        if self.every > 1:
            state["mini_step"] = self.mini_step
            state["acc"] = {n: a.detach() for n, a in self.acc.items()}
        return state

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, object]) -> None:
        """Restore `state_dict()`'s contents; each bf16 working copy is
        re-derived from its restored master."""
        self.count = int(state["count"])
        for n, m in state["masters"].items():
            self.masters[n].copy_(m)
            self.params[n].copy_(self.masters[n])
        self.adam.load_state_dict(state["adam"])
        self.mini_step = int(state.get("mini_step", 0))
        self.acc = {n: a.detach().to(self.masters[n].device, torch.float32, copy=True)
                    for n, a in state.get("acc", {}).items()}


def make_optimizer(cfg: TrainConfig, params: Dict[str, torch.Tensor],
                   initial_masters: Optional[Mapping[str, torch.Tensor]] = None,
                   lr_schedule: Optional[Callable[[int], float]] = None,
                   ) -> ClippedAdamW:
    return ClippedAdamW(params, cfg, initial_masters, lr_schedule)


def partition_disc_params(disc: Discriminator) -> Dict[str, torch.nn.Parameter]:
    """Mark D's trainable tensors, its LoRA factors and its head, and
    return them by name ("unet.<name>", "head.<name>"). Only these are
    touched: D's other tensors stay frozen as built, and a base shared
    with the generator keeps what the generator's partition set."""
    trainable = {name: p for name, p in disc.named_parameters()
                 if is_lora_path(name) or name.startswith("head.")}
    for p in trainable.values():
        p.requires_grad_(True)
    return trainable


def make_d_optimizer(cfg: TrainConfig, params: Dict[str, torch.Tensor],
                     lr: float = 2e-5, b1: float = 0.0, b2: float = 0.999,
                     max_grad_norm: float = 1.0) -> ClippedAdamW:
    """D's optimizer (defaults: scripts/sd15.sh's --learning_rate_D 2e-5,
    --adam_beta1_D 0, --adam_beta2_D 0.999, --max_grad_norm_D 1): a
    global-norm clip and AdamW at a constant rate, with the generator's
    eps and weight decay; never accumulated (D updates every step) and
    fp32 AdamW under --use_8bit_adam too, as in JAX."""
    return ClippedAdamW(params, dataclasses.replace(
        cfg, learning_rate=lr, adam_b1=b1, adam_b2=b2, max_grad_norm=max_grad_norm,
        textenc_lr=None, gradient_accumulation_steps=1, use_8bit_adam=False))


class DiscState(NamedTuple):
    """D's trainable tensors (updated in place) and their optimizer."""

    trainable: Dict[str, torch.nn.Parameter]
    optimizer: ClippedAdamW


def init_disc_state(disc: Discriminator, cfg: TrainConfig, **d_opt) -> DiscState:
    """`d_opt`: `make_d_optimizer`'s keywords."""
    trainable = partition_disc_params(disc)
    return DiscState(trainable, make_d_optimizer(cfg, trainable, **d_opt))


def _make_null_ctx_for_d(pipeline: DiffusionPipeline, disc: Optional[Discriminator]):
    """D's text condition, without gradient: (context, added condition or
    None) of the null prompts, or with `condition` of the prompts
    (--condition_discriminator, G side only), from the pipeline's text
    encoders as they stand when called. A cross-architecture D (an SD1.5
    D under an SDXL generator) reads CLIP-L's final states alone, the
    vector the reference's D-side SD1.5 text encoder makes, with no added
    condition; an SDXL D the pipeline's SDXL encoding and added condition
    (JAX's `_make_null_ctx_for_d`)."""

    def null_ctx_for_d(batch, condition: bool = False):
        ids = batch["input_ids"] if condition else batch["null_ids"]
        eos = batch.get("eos_positions") if condition else None
        with torch.no_grad():
            if disc is not None and disc.gan_cfg.cross_arch:
                eos = None if eos is None else pipeline._ids(eos)
                return pipeline.text(pipeline._ids(ids), eos)[0], None
            if not pipeline.cfg.is_sdxl:
                return pipeline.encode_prompt(ids, eos).context, None
            ids2 = batch.get("input_ids2" if condition else "null_ids2")
            enc = pipeline.encode_prompt(ids, eos, input_ids2=ids2)
            return enc.context, pipeline.sdxl_added_cond(enc.pooled, len(ids))

    return null_ctx_for_d


class TrainState(NamedTuple):
    """What one step changes: the step count, the trainable tensors (in
    place) and the optimizer holding their fp32 masters
    (`optimizer.masters`) and moments."""

    step: int
    trainable: Dict[str, torch.nn.Parameter]
    optimizer: ClippedAdamW


def init_train_state(
    pipeline: DiffusionPipeline, cfg: TrainConfig, tune_vae: bool = False,
    tune_text_encoder: bool = False,
    initial_masters: Optional[Mapping[str, torch.Tensor]] = None,
    lr_schedule: Optional[Callable[[int], float]] = None,
    full_finetuning: bool = False,
) -> TrainState:
    """`initial_masters`: fp32 tensors by trainable name ("unet.<name>",
    "vae.<name>", "text.<name>", "text2.<name>") that a bf16 tower's
    weights were rounded from, for a pipeline built from a JAX tree the
    tensors of `weights.from_jax_params` under their tower's prefix;
    without them the masters are the stored weights upcast
    (`ClippedAdamW`). The pipeline then runs its bf16 trained tensors
    through their masters (`DiffusionPipeline.set_masters`)."""
    trainable = partition_params(pipeline, tune_vae, tune_text_encoder, full_finetuning)
    opt = make_optimizer(cfg, trainable, initial_masters, lr_schedule)
    pipeline.set_masters({n: m for n, m in opt.masters.items() if m is not trainable[n]})
    return TrainState(0, trainable, opt)


class StepDraws(NamedTuple):
    """The random inputs of one step."""

    latents0: torch.Tensor      # (B, h, w, 4)
    step_noise: torch.Tensor    # (S, B, h, w, 4)
    start: int                  # first trained step
    crop: Tuple[int, int]       # (offset_x, offset_y)
    # (A,) with-replacement draws into the K segments where attribute
    # concentration captures (JAX: sample_attrcon_draws)
    attrcon_draws: Tuple[int, ...] = ()


def max_start(cfg: TrainConfig) -> int:
    return cfg.total_step - cfg.interval * (cfg.K - 1) - 1


def sample_trained_idx(cfg: TrainConfig, start: int) -> List[int]:
    """The K-step gradient schedule (training_script.py:563-566): stride
    `interval` from `start` in [0, max_start(cfg)]."""
    if not 0 <= start <= max_start(cfg):
        raise ValueError(f"start {start} outside [0, {max_start(cfg)}]")
    return [start + cfg.interval * k for k in range(cfg.K)]


def sample_draws(cfg: TrainConfig, batch: int, latent_size: int,
                 generator: torch.Generator,
                 device: Optional[torch.device] = None) -> StepDraws:
    """Draw a step's random inputs from `generator` (on its device):
    latents, noise table, then the schedule start, the crop offsets and,
    with `cfg.attrcon`, the min(attrcon_train_steps, K) segment draws."""
    device = generator.device if device is None else device
    shape = (batch, latent_size, latent_size, 4)
    latents0 = torch.randn(shape, generator=generator, device=generator.device)
    noise = torch.randn((cfg.total_step, *shape), generator=generator,
                        device=generator.device)
    offset_range = cfg.resolution // 224
    n_attrcon = min(cfg.attrcon_train_steps, cfg.K) if cfg.attrcon else 0
    ints = torch.randint(0, 1 << 30, (3 + n_attrcon,), generator=generator,
                         device=generator.device)
    with trace.sync("draws.tolist"):
        ints = ints.tolist()
    return StepDraws(
        latents0.to(device), noise.to(device), ints[0] % (max_start(cfg) + 1),
        (ints[1] % (offset_range + 1), ints[2] % (offset_range + 1)),
        tuple(i % cfg.K for i in ints[3:]),
    )


def local_draws(draws: StepDraws, mesh: Mesh) -> StepDraws:
    """This data index's rows of a global batch's draws (the latents and
    the noise table); the schedule start, the crop and the segment draws
    are the whole batch's."""
    return draws._replace(latents0=local_rows(draws.latents0, mesh),
                          step_noise=local_rows(draws.step_noise, mesh, dim=1))


# A step's segments on its clock: a pair of marks, or a span name (see
# PhaseClock). Forward first, then the backward's spans, in the order
# autograd runs them, then the updates.
SEGMENTS: Dict[str, Tuple[str, Optional[str]]] = {
    # the split step's presample and segmentation (`make_presample`,
    # SegmenterHolder.device_masks), before the differentiable step
    "presample_pass1": ("presample", "presample_pass1"),
    "presample_decode": ("presample_pass1", "presampled"),
    "segment_device": ("presampled", "segment_device"),
    "segment_host": ("segment_device", "segmented"),
    "pass1": ("start", "pass1"),
    "replay_fwd": ("pass1", "replay"),
    "capture_fwd": ("replay", "pass2"),
    "decode_fwd": ("pass2", "decoded"),
    "reward": ("decoded", "reward"),
    "gan_fwd": ("reward", "gan_g"),
    "grounding_fwd": ("gan_g", "losses"),
    "grounding_bwd": ("grounding_bwd", None),
    "gan_bwd": ("gan_bwd", None),
    "decode_bwd": ("decode_bwd", None),
    "capture_bwd": ("capture_bwd", None),
    "replay_bwd": ("replay_bwd", None),
    "allreduce": ("backward", "allreduced"),
    "optimizer": ("allreduced", "optimizer"),
    "d_fwd": ("optimizer", "d_forward"),
    "d_bwd": ("d_forward", "d_backward"),
    "d_allreduce": ("d_backward", "d_allreduced"),
    "d_opt": ("d_allreduced", "end"),
}

# The seconds a train step reports, as sums of segments. Each is stream
# seconds, the elapsed time between two marks on the device's stream, so
# the device's idle time between them is counted too: a phase whose
# launches the host cannot queue fast enough reads as long as one bound by
# its kernels (the leads below tell the two apart). s_pass1 is pass
# 1's wherever it runs: in the step, or in the split step's presample;
# s_presample is the rest of the presample (its no-grad VAE decode);
# s_segment the segmentation, device forwards and host decode, and
# s_segment_host its host part; s_allreduce the gradient all-reduces of G
# and D over the data-parallel ranks (with a mesh; else 0). s_capture and
# s_segment_host lie inside other phases; the others are disjoint.
PHASES = {
    "s_pass1": ("pass1", "presample_pass1"),
    "s_presample": ("presample_decode",),
    "s_segment": ("segment_device", "segment_host"),
    "s_segment_host": ("segment_host",),
    "s_pass2": ("replay_fwd", "capture_fwd", "replay_bwd", "capture_bwd"),
    "s_capture": ("capture_fwd", "capture_bwd"),
    "s_decode": ("decode_fwd", "decode_bwd"),
    "s_reward": ("reward",),
    "s_gan_g": ("gan_fwd", "gan_bwd"),
    "s_grounding": ("grounding_fwd", "grounding_bwd"),
    "s_allreduce": ("allreduce", "d_allreduce"),
    "s_optimizer": ("optimizer",),
    "s_d_update": ("d_fwd", "d_bwd", "d_opt"),
}

# The marks whose leads (PhaseClock.leads_ms) a step reports: the end of
# each of pass 1's guided UNet calls, in the step or its presample; the
# end of each replay segment's and capture op's forward and of their
# backward.
PASS1_MARKS = ("unet>",)
PASS2_MARKS = ("replay_op>", "capture_op>", "replay_bwd>", "capture_bwd>")


def trace_outputs(clock: PhaseClock) -> Dict[str, float]:
    """What a closed step's clock reports beside the phases: h_batch and
    h_segment_decode, the host seconds of the spans "batch" (the trainer's
    host batch) and "segment.decode" (Grounded-SAM's numpy decode);
    n_syncs, the blocking reads the step passed; lead_pass1_ms and
    lead_pass2_ms, the median lead of PASS1_MARKS and of PASS2_MARKS (0
    where the step made none). A lead near 0 says the device waited on
    the host there; a longer one, that the host ran ahead.
    pass1_graph_share: the share of pass 1's guided calls that replayed a
    CUDA graph (0 where the step made none); n_pass1_captures: the
    process's graph captures so far (`diffusion/pass1_graph.py`)."""
    def median(values):
        return statistics.median(values) if values else 0.0

    replays = clock.tallies.get("pass1_graph", 0)
    calls = replays + clock.tallies.get("pass1_eager", 0)
    return {"h_batch": clock.host_seconds("batch"),
            "h_segment_decode": clock.host_seconds("segment.decode"),
            "n_syncs": float(clock.n_syncs),
            "lead_pass1_ms": median(clock.leads_ms(*PASS1_MARKS)),
            "lead_pass2_ms": median(clock.leads_ms(*PASS2_MARKS)),
            "pass1_graph_share": replays / calls if calls else 0.0,
            "n_pass1_captures": float(pass1_graph.CAPTURES)}


def make_loss_fn(pipeline: DiffusionPipeline, blip, cfg: TrainConfig,
                 extra_losses: Optional[Callable] = None,
                 disc: Optional[Discriminator] = None,
                 mesh: Optional[Mesh] = None):
    """The differentiated quantity of a step.

    loss_fn(batch, draws) -> (loss, (metrics, latents)).
    `batch` holds input_ids, null_ids, eos_positions (optional),
    caption_ids, caption_mask and caption_labels (numpy or tensors);
    `draws` a StepDraws; with SDXL also input_ids2 and null_ids2, the
    second tokenizer's (optional). loss.backward() fills `.grad` of the trainable
    tensors. metrics: reward_blip, reward_total, reward_norm, step_loss
    (0-dim tensors), G_loss with `disc`, and what `extra_losses` adds.

    With `cfg.attrcon` the replay captures the cross-attention maps at
    the segments `draws.attrcon_draws`. `disc`: the GAN's G loss, D's
    logits of the final latents against "real" at the last inference
    timestep, weighted by `cfg.gan_loss_weight`; it reaches the latents
    and not D's tensors. `extra_losses(batch, image, result, draws)` ->
    (loss to add, metrics), e.g. `training.attrcon.make_attrcon_extra_losses`.

    `cfg.gradient_checkpointing` runs pass 1 unfused, as JAX does: the
    pipeline must then hold no LoRA-free twin (`fuse_pass1=False`).
    `cfg.pass1_int8` runs pass 1 in W8A8 on that UNet.

    With `mesh` the batch and `draws` are this data index's rows of the
    global batch, and the loss is this rank's share of the global loss, so
    that the shares and their gradients sum over the data group to JAX's
    at the global batch: the caption loss is the local token losses' sum
    over the global count of scored tokens (all-reduced first), every
    other term (the G loss, the grounding losses) the local mean over the
    number of data groups (equal rows per rank). The metrics are the
    shares too (`make_train_step` sums them), but for `reward_norm`, the
    norm of the whole batch's image gradient."""
    if (cfg.gradient_checkpointing and pipeline.cfg.lora_rank > 0
            and pipeline.unet_inf is not None):
        raise ValueError("gradient_checkpointing runs pass 1 unfused: build the "
                         "pipeline with DiffusionPipeline(..., fuse_pass1=False)")
    t_final = int(inference_timesteps(cfg.total_step)[-1])
    null_ctx_for_d = _make_null_ctx_for_d(pipeline, disc)
    share = 1.0 / mesh.data if mesh is not None else None

    def scored_tokens(batch) -> Optional[torch.Tensor]:
        """The global batch's count of scored caption tokens (with a mesh)."""
        if mesh is None:
            return None
        labels = torch.as_tensor(np.asarray(batch["caption_labels"]))
        count = (labels[:, 1:] != IGNORE_INDEX).sum().to(pipeline.device)
        return sum_over_data(count, mesh).clamp_min(1)

    def caption_loss_of_image(img, batch, count):
        r = blip_caption_reward(blip, img, batch["caption_ids"],
                                batch["caption_mask"], batch["caption_labels"],
                                token_count=count)
        return -(cfg.reward_weight * r)

    def image_grad_norm(img_grad: torch.Tensor) -> torch.Tensor:
        if mesh is None or mesh.data == 1:
            return img_grad.float().norm()
        return sum_over_data(img_grad.float().square().sum(), mesh).sqrt()

    def loss_fn(batch, draws: StepDraws):
        # the marks go to the active clock (comat_tpu_torch.trace), if any
        traced = trace.current() is not None

        def hook(tensor, name):
            """Mark `name` when autograd runs the node that made `tensor`,
            which it does in the reverse order of the nodes' creation
            among those whose gradients are ready. A view made just
            before a stage's first op marks that stage's end."""
            if traced and tensor.requires_grad:
                tensor.register_hook(lambda g: trace.mark(name))

        trace.mark("start")
        trained_idx = sample_trained_idx(cfg, draws.start)
        presampled = None
        if "eps_table" in batch:     # the split step: pass 1 ran in the presample
            presampled = (batch["eps_table"], batch["latents_traj"])
        image, result = pipeline.forward(
            batch["input_ids"], batch["null_ids"], trained_idx,
            num_inference_steps=cfg.total_step, K=cfg.K,
            guidance_scale=cfg.guidance_scale,
            guidance_rescale=cfg.guidance_rescale,
            eos_positions=batch.get("eos_positions"),
            input_ids2=batch.get("input_ids2"), null_ids2=batch.get("null_ids2"),
            train_text_encoder=cfg.train_text_encoder,
            latents0=draws.latents0, step_noise=draws.step_noise,
            capture=cfg.attrcon, capture_idx=draws.attrcon_draws,
            remat=cfg.remat_min_res if cfg.remat_min_res else cfg.gradient_checkpointing,
            presampled=presampled, pass1_int8=cfg.pass1_int8,
        )
        trace.mark("decoded")
        hook(image, "decode_bwd<")    # "decode_bwd>": see pipeline.forward

        with trace.span("losses"):
            offset_range = cfg.resolution // 224
            cropped = crop_jitter(image, *draws.crop, cfg.resolution - offset_range)
            leaf = cropped.detach().requires_grad_()
            count = scored_tokens(batch)
            with torch.enable_grad():
                closs = caption_loss_of_image(leaf, batch, count)
                (img_grad,) = torch.autograd.grad(closs, leaf)
            closs = closs.detach()
            reward_norm = image_grad_norm(img_grad)
            factor = (1e4 / reward_norm.clamp_min(1e-12)) if cfg.norm_grad else 1.0
            loss = closs + ((img_grad * factor).detach()
                            * (cropped - cropped.detach())).sum()
            reward = -closs / cfg.reward_weight
            trace.mark("reward")
            metrics = {
                "reward_blip": reward,
                "reward_total": cfg.reward_weight * reward,
                "reward_norm": reward_norm,
            }

            if disc is not None:
                null_ctx, null_added = null_ctx_for_d(
                    batch, condition=disc.gan_cfg.condition_discriminator)
                lat_d = result.latents.view_as(result.latents)
                hook(lat_d, "gan_bwd>")
                g_loss = gan_g_loss(disc, lat_d, t_final, null_ctx, null_added)
                if share is not None:
                    g_loss = g_loss * share
                hook(g_loss, "gan_bwd<")
                loss = loss + cfg.gan_loss_weight * g_loss
                metrics["G_loss"] = g_loss.detach()
            trace.mark("gan_g")

            if extra_losses is not None:
                if traced:
                    views = {k: [m.view_as(m) for m in v]
                             for k, v in result.captured.items()}
                    maps = [m for v in views.values() for m in v if m.requires_grad]
                    left = [len(maps)]

                    def last_map(g):    # the grounding backward ends at the last map
                        left[0] -= 1
                        if left[0] == 0:
                            trace.mark("grounding_bwd>")

                    for m in maps:
                        m.register_hook(last_map)
                    result = result._replace(captured=views)
                add, extra_metrics = extra_losses(batch, image, result, draws)
                if share is not None:
                    add = add * share
                    extra_metrics = {k: v * share for k, v in extra_metrics.items()}
                hook(add, "grounding_bwd<")
                loss = loss + add
                metrics.update(extra_metrics)
            trace.mark("losses")
        metrics["step_loss"] = loss.detach()
        return loss, (metrics, result.latents)

    return loss_fn


def make_train_step(pipeline: DiffusionPipeline, blip, cfg: TrainConfig,
                    extra_losses: Optional[Callable] = None,
                    disc: Optional[Discriminator] = None,
                    d_optimizer: Optional[ClippedAdamW] = None,
                    mesh: Optional[Mesh] = None):
    """train_step(state, batch, draws=None, generator=None, clock=None) ->
    (new state, metrics).

    `draws` are the step's random inputs; without them they are drawn
    from `generator`. With `disc` the loss holds the GAN's G term; with
    `d_optimizer` too (`init_disc_state(disc, cfg).optimizer`) the step
    then updates D, after the generator as JAX does: D's loss on the
    detached final latents (label 0) and `batch["gt_latents"]` (label
    1), both under the null prompts' encoding by the text encoder as the
    generator's update left it (for a cross-architecture D, CLIP-L's final
    states; for an SDXL D, with SDXL's added condition).

    metrics (Python floats): reward_blip, reward_total, reward_norm,
    step_loss, grad_norm (before the clip), G_loss and D_loss with the
    GAN, token_loss and pixel_loss with attribute concentration, and the
    stream seconds of the step's phases (`PHASES`: the time between their
    marks on the device's stream, its idle time included): s_pass1
    (encode and pass 1, here or in a presample on the same clock),
    s_presample and s_segment (a split step's, see `make_presample`;
    0 otherwise), s_pass2 (the replay and the capture, forward and
    backward; s_capture the capture alone), s_decode (forward and
    backward), s_reward (crop, BLIP forward and backward), s_gan_g (D's
    forward and backward for the G loss), s_grounding (the grounding
    losses, forward and backward), s_optimizer, s_d_update (D's loss,
    backward and optimizer), s_step (the clock's first mark to its last);
    and what the clock traced (`trace_outputs`): h_batch,
    h_segment_decode, n_syncs, lead_pass1_ms, lead_pass2_ms,
    pass1_graph_share, n_pass1_captures.
    A batch holding `eps_table` and `latents_traj` (a presample's) skips
    pass 1 and replays from them. `clock`: a PhaseClock to mark the
    step on (one is made without it), for a caller that reads more of
    it, e.g. launch counts by segment through its probe. The step is the
    clock's active one (`PhaseClock.active`) and takes its spans and syncs
    on it; it ends with `clock.close()`, the step's one wait for the
    device, before the metrics are read.

    `mesh` (parallel.mesh): data parallelism over its data group, with the
    batch this data index's rows of the global batch (the model group's
    ranks hold the same rows). `draws`, given or drawn, are the global
    batch's, the same on every rank, and the step keeps its rows
    (`local_draws`), so every rank's generator stays in step with the
    others'. Each loss is this rank's share of the global one
    (`make_loss_fn`); after the backward the gradients of G, and after
    D's backward D's, are summed over the data group in flat fp32
    buckets (`all_reduce_grads`), so that the clip, the accumulation and
    AdamW see the global gradient, as optax does in JAX. Under
    `parallel.tp` the clip's norm counts each shard across its model
    group. The metrics are the global batch's, and `allreduce_bytes`
    the bytes summed; `s_allreduce` is the all-reduces' seconds."""
    loss_fn = make_loss_fn(pipeline, blip, cfg, extra_losses, disc, mesh)
    t_final = int(inference_timesteps(cfg.total_step)[-1])
    null_ctx_for_d = _make_null_ctx_for_d(pipeline, disc)
    sharded = {f"unet.{n}" for n in getattr(pipeline.unet, "tp_sharded", ())}

    def norm(grads):
        return grad_norm(grads, mesh, sharded)

    def train_step(state: TrainState, batch, draws: Optional[StepDraws] = None,
                   generator: Optional[torch.Generator] = None,
                   clock: Optional[PhaseClock] = None):
        clock = PhaseClock(pipeline.device) if clock is None else clock
        with clock.active(), clock.span("train_step"):
            if draws is None:
                n = len(batch["input_ids"]) * (mesh.data if mesh is not None else 1)
                with clock.span("draws"):
                    draws = sample_draws(cfg, n, pipeline.cfg.latent_size, generator,
                                         pipeline.device)
            if mesh is not None:
                draws = local_draws(draws, mesh)
            reduced = [0]

            def reduce_then_mark(name):
                def reduce(grads):
                    reduced[0] += all_reduce_grads(grads, mesh)
                    clock.mark(name)
                return reduce

            state.optimizer.zero_grad()
            loss, (metrics, gen_latents) = loss_fn(batch, draws)
            with clock.span("backward"):
                loss.backward()
            clock.mark("backward")
            with clock.span("optimizer"):
                if mesh is None:
                    clock.mark("allreduced")
                    g_norm = state.optimizer.step()
                else:
                    g_norm = state.optimizer.step(reduce_then_mark("allreduced"), norm)
            clock.mark("optimizer")
            if disc is not None and d_optimizer is not None:
                with clock.span("d_update"):
                    null_ctx, null_added = null_ctx_for_d(batch)
                    gt = batch["gt_latents"]
                    if not isinstance(gt, torch.Tensor):
                        gt = torch.from_numpy(np.asarray(gt))
                    d_optimizer.zero_grad()
                    d_loss = gan_d_loss(disc, gen_latents, gt, t_final, null_ctx,
                                        null_added)
                    if mesh is not None:
                        d_loss = d_loss * (1.0 / mesh.data)
                    clock.mark("d_forward")
                    d_loss.backward()
                    clock.mark("d_backward")
                    if mesh is None:
                        clock.mark("d_allreduced")
                        d_optimizer.step()
                    else:
                        d_optimizer.step(reduce_then_mark("d_allreduced"))
                    metrics["D_loss"] = d_loss.detach()
            else:
                clock.mark("d_forward")
                clock.mark("d_backward")
            clock.mark("end")
            if mesh is not None:
                norm_metric = metrics.pop("reward_norm")
                metrics = gather_metrics(metrics, mesh)
                metrics["reward_norm"] = norm_metric
            # the step's one wait for the device; the reads after it find
            # their values computed
            clock.close()
            with clock.span("metrics"):
                out = {}
                for k, v in [*metrics.items(), ("grad_norm", g_norm)]:
                    with clock.sync("metrics.read"):
                        out[k] = float(v)
                if mesh is not None:
                    out["allreduce_bytes"] = float(reduced[0])
                seg = {name: clock.seconds(*marks) for name, marks in SEGMENTS.items()}
                for name, parts in PHASES.items():
                    out[name] = sum(seg[p] for p in parts)
                out["s_step"] = clock.span_seconds()
                out.update(trace_outputs(clock))
        return TrainState(state.step + 1, state.trainable, state.optimizer), out

    return train_step


def make_presample(pipeline: DiffusionPipeline, cfg: TrainConfig):
    """The split step's no-grad presample (JAX's `make_presample`,
    comat_tpu/training/train_step.py:550-588): presample(batch, draws,
    clock=None) -> (image (B, H, W, 3) unclamped, eps_table, latents_traj).

    With an image-dependent segmenter (Grounded-SAM) a step runs: this
    presample (pass 1 and the VAE decode, without gradients), the
    segmentation of its image (`SegmenterHolder.device_masks`), then the
    train step on the same `draws` with the masks and the two tables in
    the batch (`seg_masks`, `eps_table`, `latents_traj`): its forward
    replays from the tables instead of sampling again, so the 50 pass-1
    UNet calls are not paid twice. The draws' latents and noise table are
    the step's own, so the replayed trajectory is the presampled one
    exactly. On `clock` (one is made without it) it marks "presample",
    "presample_pass1" and "presampled", and takes the span "presample"
    with pass 1's spans inside it."""

    def presample(batch, draws: StepDraws, clock: Optional[PhaseClock] = None):
        clock = PhaseClock(pipeline.device) if clock is None else clock
        with clock.active(), clock.span("presample"):
            clock.mark("presample")
            image, eps_table, traj = pipeline.presample(
                batch["input_ids"], batch["null_ids"],
                num_inference_steps=cfg.total_step, guidance_scale=cfg.guidance_scale,
                guidance_rescale=cfg.guidance_rescale,
                eos_positions=batch.get("eos_positions"),
                input_ids2=batch.get("input_ids2"), null_ids2=batch.get("null_ids2"),
                latents0=draws.latents0, step_noise=draws.step_noise,
                pass1_int8=cfg.pass1_int8,
            )
            clock.mark("presampled")
        return image, eps_table, traj

    return presample
