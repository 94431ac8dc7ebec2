"""The CoMat train step: the concept-matching (BLIP) reward, the latent
GAN and attribute concentration.

Port of comat_tpu/training/train_step.py (`TrainConfig`, `DiscState`,
`partition_params`, `partition_disc_params`, `make_optimizer`,
`make_d_optimizer`, `init_disc_state`, `sample_trained_idx`,
`make_loss_fn`, `make_train_step`, `make_presample`) without 8-bit Adam, the int8 pass 1
or gradient accumulation: each of those raises `NotImplementedError`
naming its ROADMAP item. One step: encode the prompts, pass 1 (50
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
import time
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from comat_tpu_torch.diffusion.schedulers import inference_timesteps
from comat_tpu_torch.losses.caption_reward import blip_caption_reward, crop_jitter
from comat_tpu_torch.losses.gan import Discriminator, gan_d_loss, gan_g_loss
from comat_tpu_torch.models.lora import is_lora_path
from comat_tpu_torch.models.pipeline import DiffusionPipeline


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
    pass1_int8: bool = False
    textenc_lr: Optional[float] = None   # --textenc_lora_lr

    @property
    def interval(self) -> int:
        return self.total_step // self.K


# Flags whose paths are not ported yet, and the ROADMAP item of each, by
# its title in Queue 1.
_NOT_PORTED = (
    ("use_8bit_adam", "ROADMAP Queue 1: opt-in extras (8-bit Adam)"),
    ("pass1_int8", "ROADMAP Queue 1: opt-in extras (W8A8 pass 1)"),
)


def _check_ported(cfg: TrainConfig) -> None:
    for flag, item in _NOT_PORTED:
        if getattr(cfg, flag):
            raise NotImplementedError(f"TrainConfig.{flag}: not ported yet, {item}")
    if cfg.gradient_accumulation_steps > 1:
        raise NotImplementedError(
            "gradient_accumulation_steps > 1: not ported yet, ROADMAP Queue 1: "
            "torch DDP with gradient accumulation")


def partition_params(
    pipeline: DiffusionPipeline,
    tune_vae: bool = False,
    tune_text_encoder: bool = False,
) -> Dict[str, torch.nn.Parameter]:
    """Mark the trainable tensors of the pipeline and return them by name
    ("unet.<name>", "vae.<name>", "text.<name>"): the UNet's LoRA factors,
    and the whole VAE (encoder and decoder, as JAX marks its `vae`
    subtree) or the text encoder with the flags of the same names. Every
    other parameter is set frozen (`requires_grad` off). The encoder gets
    no gradient (the step only decodes), so AdamW's weight decay alone
    moves it, as in JAX.

    A tensor of a bf16 tower stays bf16 here, the module's working copy;
    the optimizer keeps its fp32 master (`ClippedAdamW`)."""
    marks = [
        (f"{tower}.{name}", p, is_lora_path(name)
         or (tune_vae and tower == "vae")
         or (tune_text_encoder and tower == "text"))
        for tower, module in (("unet", pipeline.unet), ("text", pipeline.text),
                              ("vae", pipeline.vae))
        for name, p in module.named_parameters()
    ]
    for _, p, train in marks:
        p.requires_grad_(train)
    return {name: p for name, p, train in marks if train}


class ClippedAdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(...)) over named
    tensors, with a second AdamW group for the text encoder's tensors when
    `textenc_lr` is set (the clip stays joint, as in JAX).

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

    The clip is written as optax writes it: gradients are left as they are
    when their global norm is below `max_norm`, else divided by the norm
    and multiplied by `max_norm` (no epsilon, unlike
    `torch.nn.utils.clip_grad_norm_`). A trainable tensor without a
    gradient gets a zero one, so that weight decay reaches it as in optax.
    AdamW itself is `torch.optim.AdamW`: the same update as optax.adamw
    (bias-corrected moments, eps outside the square root, decoupled weight
    decay scaled by the learning rate)."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: TrainConfig,
                 initial_masters: Optional[Mapping[str, torch.Tensor]] = None,
                 lr_schedule: Optional[Callable[[int], float]] = None):
        self.params = params
        self.max_norm = cfg.max_grad_norm
        self.lr_schedule = lr_schedule
        self.count = 0
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
        main = [m for n, m in self.masters.items() if not n.startswith("text.")]
        text = [m for n, m in self.masters.items() if n.startswith("text.")]
        groups = [{"params": main, "lr": cfg.learning_rate}]
        if text:
            groups.append({"params": text, "lr": cfg.textenc_lr
                           if cfg.textenc_lr is not None else cfg.learning_rate})
        groups = [g for g in groups if g["params"]]
        # each group's rate as a fraction of the schedule's
        self._ratios = [g["lr"] / cfg.learning_rate if cfg.learning_rate else 0.0
                        for g in groups]
        self.adam = torch.optim.AdamW(
            groups, lr=cfg.learning_rate,
            betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
            weight_decay=cfg.adam_weight_decay,
        )

    def zero_grad(self) -> None:
        for name, p in self.params.items():
            p.grad = None
            self.masters[name].grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip and apply the gradients in `.grad`; returns their global
        norm before the clip (a 0-dim fp32 tensor). The working copies'
        own `.grad` are left as the backward wrote them."""
        for name, p in self.params.items():
            master = self.masters[name]
            if master is not p and p.grad is not None:
                g = p.grad.float()
                master.grad = g if master.grad is None else master.grad + g
            if master.grad is None:
                master.grad = torch.zeros_like(master)
        grads = [m.grad for m in self.masters.values()]
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        if float(norm) >= self.max_norm:
            for g in grads:
                g.div_(norm).mul_(self.max_norm)
        if self.lr_schedule is not None:
            lr = float(self.lr_schedule(self.count))
            for group, ratio in zip(self.adam.param_groups, self._ratios):
                group["lr"] = lr * ratio
        self.adam.step()
        self.count += 1
        for name, p in self.params.items():
            if self.masters[name] is not p:
                p.copy_(self.masters[name])
        return norm

    def state_dict(self) -> Dict[str, object]:
        """The update count, the fp32 masters of bf16 tensors and AdamW's
        state (moments and steps), for a checkpoint."""
        return {"count": self.count, "adam": self.adam.state_dict(),
                "masters": {n: m.detach() for n, m in self.masters.items()
                            if m is not self.params[n]}}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, object]) -> None:
        """Restore `state_dict()`'s contents; each bf16 working copy is
        re-derived from its restored master."""
        self.count = int(state["count"])
        for n, m in state["masters"].items():
            self.masters[n].copy_(m)
            self.params[n].copy_(self.masters[n])
        self.adam.load_state_dict(state["adam"])


def make_optimizer(cfg: TrainConfig, params: Dict[str, torch.Tensor],
                   initial_masters: Optional[Mapping[str, torch.Tensor]] = None,
                   lr_schedule: Optional[Callable[[int], float]] = None,
                   ) -> ClippedAdamW:
    _check_ported(cfg)
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
    eps and weight decay."""
    return ClippedAdamW(params, dataclasses.replace(
        cfg, learning_rate=lr, adam_b1=b1, adam_b2=b2, max_grad_norm=max_grad_norm,
        textenc_lr=None))


class DiscState(NamedTuple):
    """D's trainable tensors (updated in place) and their optimizer."""

    trainable: Dict[str, torch.nn.Parameter]
    optimizer: ClippedAdamW


def init_disc_state(disc: Discriminator, cfg: TrainConfig, **d_opt) -> DiscState:
    """`d_opt`: `make_d_optimizer`'s keywords."""
    trainable = partition_disc_params(disc)
    return DiscState(trainable, make_d_optimizer(cfg, trainable, **d_opt))


def _make_null_ctx_for_d(pipeline: DiffusionPipeline):
    """D's text condition, without gradient: the null prompts' encoding,
    or with `condition` the prompts' (--condition_discriminator, G side
    only), from the pipeline's text encoder as it stands when called."""

    def null_ctx_for_d(batch, condition: bool = False) -> torch.Tensor:
        ids = batch["input_ids"] if condition else batch["null_ids"]
        eos = batch.get("eos_positions") if condition else None
        with torch.no_grad():
            return pipeline.encode_prompt(ids, eos).context

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
) -> TrainState:
    """`initial_masters`: fp32 tensors by trainable name ("vae.<name>",
    "text.<name>") that a bf16 tower's weights were rounded from, for a
    pipeline built from a JAX tree the tensors of
    `weights.from_jax_params` under their tower's prefix; without them the
    masters are the stored weights upcast (`ClippedAdamW`). The pipeline
    then runs its bf16 trained tensors through their masters
    (`DiffusionPipeline.set_masters`)."""
    trainable = partition_params(pipeline, tune_vae, tune_text_encoder)
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
                         device=generator.device).tolist()
    return StepDraws(
        latents0.to(device), noise.to(device), ints[0] % (max_start(cfg) + 1),
        (ints[1] % (offset_range + 1), ints[2] % (offset_range + 1)),
        tuple(i % cfg.K for i in ints[3:]),
    )


class PhaseClock:
    """Marks on the device's timeline (CUDA events; host clock on the
    CPU), read after the step has synchronised.

    A name may be marked more than once. `seconds(a, b)` spans the last
    mark `a` to the last mark `b` (0 when either was not marked: a stage
    the step did not run); `seconds(name)` sums the spans between the
    marks `name<` and `name>` taken in pairs (the backward of each replay
    op, for instance); `span()` runs from the first mark to the last.
    `probe`, when given, is called at each mark (e.g. to read kernel
    launch counters), and `counts` takes the differences of its readings
    over the same spans."""

    def __init__(self, device: torch.device,
                 probe: Optional[Callable[[], Dict[str, int]]] = None):
        self.cuda = device.type == "cuda"
        self.probe = probe
        self.marks: Dict[str, List[Tuple[object, Optional[Dict[str, int]]]]] = {}
        self.stamps: List[object] = []      # every mark's stamp, in order

    def mark(self, name: str) -> None:
        if self.cuda:
            stamp = torch.cuda.Event(enable_timing=True)
            stamp.record()
        else:
            stamp = time.perf_counter()
        reading = self.probe() if self.probe is not None else None
        self.marks.setdefault(name, []).append((stamp, reading))
        self.stamps.append(stamp)

    def _pairs(self, a: str, b: Optional[str]):
        if b is not None:
            if a not in self.marks or b not in self.marks:
                return []       # a stage this step did not run
            return [(self.marks[a][-1], self.marks[b][-1])]
        begins, ends = self.marks.get(a + "<", []), self.marks.get(a + ">", [])
        if len(begins) != len(ends):
            raise RuntimeError(f"span {a}: {len(begins)} begins, {len(ends)} ends")
        return list(zip(begins, ends))

    def seconds(self, a: str, b: Optional[str] = None) -> float:
        total = 0.0
        for (sa, _), (sb, _) in self._pairs(a, b):
            total += sa.elapsed_time(sb) / 1e3 if self.cuda else sb - sa
        return total

    def span(self) -> float:
        """Seconds from the clock's first mark to its last."""
        if not self.stamps:
            return 0.0
        sa, sb = self.stamps[0], self.stamps[-1]
        return sa.elapsed_time(sb) / 1e3 if self.cuda else sb - sa

    def counts(self, a: str, b: Optional[str] = None) -> Dict[str, int]:
        total: Dict[str, int] = {}
        for (_, ra), (_, rb) in self._pairs(a, b):
            for k in rb:
                total[k] = total.get(k, 0) + rb[k] - ra[k]
        return total


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
    "optimizer": ("backward", "optimizer"),
    "d_fwd": ("optimizer", "d_forward"),
    "d_bwd": ("d_forward", "d_backward"),
    "d_opt": ("d_backward", "end"),
}

# The seconds a train step reports, as sums of segments. s_pass1 is pass
# 1's wherever it runs: in the step, or in the split step's presample;
# s_presample is the rest of the presample (its no-grad VAE decode);
# s_segment the segmentation, device forwards and host decode, and
# s_segment_host its host part. s_capture and s_segment_host lie inside
# other phases; the others are disjoint.
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
    "s_optimizer": ("optimizer",),
    "s_d_update": ("d_fwd", "d_bwd", "d_opt"),
}


def make_loss_fn(pipeline: DiffusionPipeline, blip, cfg: TrainConfig,
                 extra_losses: Optional[Callable] = None,
                 disc: Optional[Discriminator] = None):
    """The differentiated quantity of a step.

    loss_fn(batch, draws, clock=None) -> (loss, (metrics, latents)).
    `batch` holds input_ids, null_ids, eos_positions (optional),
    caption_ids, caption_mask and caption_labels (numpy or tensors);
    `draws` a StepDraws. loss.backward() fills `.grad` of the trainable
    tensors. metrics: reward_blip, reward_total, reward_norm, step_loss
    (0-dim tensors), G_loss with `disc`, and what `extra_losses` adds.

    With `cfg.attrcon` the replay captures the cross-attention maps at
    the segments `draws.attrcon_draws`. `disc`: the GAN's G loss, D's
    logits of the final latents against "real" at the last inference
    timestep, weighted by `cfg.gan_loss_weight`; it reaches the latents
    and not D's tensors. `extra_losses(batch, image, result, draws)` ->
    (loss to add, metrics), e.g. `training.attrcon.make_attrcon_extra_losses`.

    `cfg.gradient_checkpointing` runs pass 1 unfused, as JAX does: the
    pipeline must then hold no LoRA-free twin (`fuse_pass1=False`)."""
    _check_ported(cfg)
    if (cfg.gradient_checkpointing and pipeline.cfg.lora_rank > 0
            and pipeline.unet_inf is not None):
        raise ValueError("gradient_checkpointing runs pass 1 unfused: build the "
                         "pipeline with DiffusionPipeline(..., fuse_pass1=False)")
    t_final = int(inference_timesteps(cfg.total_step)[-1])
    null_ctx_for_d = _make_null_ctx_for_d(pipeline)

    def caption_loss_of_image(img, batch):
        r = blip_caption_reward(blip, img, batch["caption_ids"],
                                batch["caption_mask"], batch["caption_labels"])
        return -(cfg.reward_weight * r)

    def loss_fn(batch, draws: StepDraws, clock: Optional[PhaseClock] = None):
        mark = clock.mark if clock is not None else (lambda name: None)

        def hook(tensor, name):
            """Mark `name` when autograd runs the node that made `tensor`,
            which it does in the reverse order of the nodes' creation
            among those whose gradients are ready. A view made just
            before a stage's first op marks that stage's end."""
            if clock is not None and tensor.requires_grad:
                tensor.register_hook(lambda g: mark(name))

        mark("start")
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
            train_text_encoder=cfg.train_text_encoder,
            latents0=draws.latents0, step_noise=draws.step_noise,
            capture=cfg.attrcon, capture_idx=draws.attrcon_draws, mark=mark,
            remat=cfg.remat_min_res if cfg.remat_min_res else cfg.gradient_checkpointing,
            presampled=presampled,
        )
        mark("decoded")
        hook(image, "decode_bwd<")    # "decode_bwd>": see pipeline.forward

        offset_range = cfg.resolution // 224
        cropped = crop_jitter(image, *draws.crop, cfg.resolution - offset_range)
        leaf = cropped.detach().requires_grad_()
        with torch.enable_grad():
            closs = caption_loss_of_image(leaf, batch)
            (img_grad,) = torch.autograd.grad(closs, leaf)
        closs = closs.detach()
        reward_norm = img_grad.float().norm()
        factor = (1e4 / reward_norm.clamp_min(1e-12)) if cfg.norm_grad else 1.0
        loss = closs + ((img_grad * factor).detach()
                        * (cropped - cropped.detach())).sum()
        reward = -closs / cfg.reward_weight
        mark("reward")
        metrics = {
            "reward_blip": reward,
            "reward_total": cfg.reward_weight * reward,
            "reward_norm": reward_norm,
        }

        if disc is not None:
            null_ctx = null_ctx_for_d(
                batch, condition=disc.gan_cfg.condition_discriminator)
            lat_d = result.latents.view_as(result.latents)
            hook(lat_d, "gan_bwd>")
            g_loss = gan_g_loss(disc, lat_d, t_final, null_ctx)
            hook(g_loss, "gan_bwd<")
            loss = loss + cfg.gan_loss_weight * g_loss
            metrics["G_loss"] = g_loss.detach()
        mark("gan_g")

        if extra_losses is not None:
            if clock is not None:
                views = {k: [m.view_as(m) for m in v]
                         for k, v in result.captured.items()}
                maps = [m for v in views.values() for m in v if m.requires_grad]
                left = [len(maps)]

                def last_map(g):    # the grounding backward ends at the last map
                    left[0] -= 1
                    if left[0] == 0:
                        mark("grounding_bwd>")

                for m in maps:
                    m.register_hook(last_map)
                result = result._replace(captured=views)
            add, extra_metrics = extra_losses(batch, image, result, draws)
            hook(add, "grounding_bwd<")
            loss = loss + add
            metrics.update(extra_metrics)
        mark("losses")
        metrics["step_loss"] = loss.detach()
        return loss, (metrics, result.latents)

    return loss_fn


def make_train_step(pipeline: DiffusionPipeline, blip, cfg: TrainConfig,
                    extra_losses: Optional[Callable] = None,
                    disc: Optional[Discriminator] = None,
                    d_optimizer: Optional[ClippedAdamW] = None):
    """train_step(state, batch, draws=None, generator=None, clock=None) ->
    (new state, metrics).

    `draws` are the step's random inputs; without them they are drawn
    from `generator`. With `disc` the loss holds the GAN's G term; with
    `d_optimizer` too (`init_disc_state(disc, cfg).optimizer`) the step
    then updates D, after the generator as JAX does: D's loss on the
    detached final latents (label 0) and `batch["gt_latents"]` (label
    1), both under the null prompts' encoding by the text encoder as the
    generator's update left it.

    metrics (Python floats): reward_blip, reward_total, reward_norm,
    step_loss, grad_norm (before the clip), G_loss and D_loss with the
    GAN, token_loss and pixel_loss with attribute concentration, and the
    seconds of the step's phases on its device (`PHASES`): s_pass1
    (encode and pass 1, here or in a presample on the same clock),
    s_presample and s_segment (a split step's, see `make_presample`;
    0 otherwise), s_pass2 (the replay and the capture, forward and
    backward; s_capture the capture alone), s_decode (forward and
    backward), s_reward (crop, BLIP forward and backward), s_gan_g (D's
    forward and backward for the G loss), s_grounding (the grounding
    losses, forward and backward), s_optimizer, s_d_update (D's loss,
    backward and optimizer), s_step (the clock's first mark to its last).
    A batch holding `eps_table` and `latents_traj` (a presample's) skips
    pass 1 and replays from them. `clock`: a PhaseClock to mark the
    step on (one is made without it), for a caller that reads more of
    it, e.g. launch counts by segment through its probe."""
    loss_fn = make_loss_fn(pipeline, blip, cfg, extra_losses, disc)
    t_final = int(inference_timesteps(cfg.total_step)[-1])
    null_ctx_for_d = _make_null_ctx_for_d(pipeline)

    def train_step(state: TrainState, batch, draws: Optional[StepDraws] = None,
                   generator: Optional[torch.Generator] = None,
                   clock: Optional[PhaseClock] = None):
        if draws is None:
            draws = sample_draws(cfg, len(batch["input_ids"]),
                                 pipeline.cfg.latent_size, generator,
                                 pipeline.device)
        clock = PhaseClock(pipeline.device) if clock is None else clock
        state.optimizer.zero_grad()
        loss, (metrics, gen_latents) = loss_fn(batch, draws, clock)
        loss.backward()
        clock.mark("backward")
        grad_norm = state.optimizer.step()
        clock.mark("optimizer")
        if disc is not None and d_optimizer is not None:
            null_ctx = null_ctx_for_d(batch)
            gt = batch["gt_latents"]
            if not isinstance(gt, torch.Tensor):
                gt = torch.from_numpy(np.asarray(gt))
            d_optimizer.zero_grad()
            d_loss = gan_d_loss(disc, gen_latents, gt, t_final, null_ctx)
            clock.mark("d_forward")
            d_loss.backward()
            clock.mark("d_backward")
            d_optimizer.step()
            metrics["D_loss"] = d_loss.detach()
        else:
            clock.mark("d_forward")
            clock.mark("d_backward")
        clock.mark("end")
        out = {k: float(v) for k, v in metrics.items()}
        out["grad_norm"] = float(grad_norm)
        seg = {name: clock.seconds(*marks) for name, marks in SEGMENTS.items()}
        for name, parts in PHASES.items():
            out[name] = sum(seg[p] for p in parts)
        out["s_step"] = clock.span()
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
    exactly. On `clock` it marks "presample", "presample_pass1" and
    "presampled"."""

    def presample(batch, draws: StepDraws, clock: Optional[PhaseClock] = None):
        mark = clock.mark if clock is not None else (lambda name: None)
        mark("presample")
        image, eps_table, traj = pipeline.presample(
            batch["input_ids"], batch["null_ids"],
            num_inference_steps=cfg.total_step, guidance_scale=cfg.guidance_scale,
            guidance_rescale=cfg.guidance_rescale,
            eos_positions=batch.get("eos_positions"),
            latents0=draws.latents0, step_noise=draws.step_noise,
            mark=lambda name: mark("presample_" + name),
        )
        mark("presampled")
        return image, eps_table, traj

    return presample
