"""The CoMat train step, reduced to the concept-matching (BLIP) reward.

Port of comat_tpu/training/train_step.py (`TrainConfig`,
`partition_params`, `make_optimizer`, `sample_trained_idx`,
`make_loss_fn`, `make_train_step`) without the GAN, attribute
concentration, 8-bit Adam or gradient accumulation: each of those raises
`NotImplementedError` naming its ROADMAP item. One step: encode the
prompts, pass 1 (50 no-grad CFG UNet calls with LoRA fused), pass 2 (the
K cached-primal replay segments), VAE decode with gradient, crop jitter,
the BLIP caption loss and the reward-gradient tap, backward, then a
global-norm clip and AdamW on the trainable tensors.

Randomness is injected: a `StepDraws` holds the initial latents, the
per-step noise table (S, B, h, w, 4), the K-schedule start and the crop
offsets; `sample_draws` makes one from a `torch.Generator`.

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

import torch

from comat_tpu_torch.losses.caption_reward import blip_caption_reward, crop_jitter
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
    attrcon: bool = False
    gradient_accumulation_steps: int = 1
    use_8bit_adam: bool = False     # --use_8bit_adam
    gradient_checkpointing: bool = False
    remat_min_res: Optional[int] = None
    pass1_int8: bool = False
    textenc_lr: Optional[float] = None   # --textenc_lora_lr

    @property
    def interval(self) -> int:
        return self.total_step // self.K


# Flags whose paths are not ported yet, and the ROADMAP item of each.
_NOT_PORTED = (
    ("gan_loss", "ROADMAP Queue 1 item 9 (GAN loss and the D update)"),
    ("attrcon", "ROADMAP Queue 1 item 10 (attribute concentration)"),
    ("use_8bit_adam", "ROADMAP Queue 1 item 16 (8-bit Adam)"),
    ("gradient_checkpointing", "ROADMAP Queue 1 item 3 (remat)"),
    ("remat_min_res", "ROADMAP Queue 1 item 3 (remat)"),
    ("pass1_int8", "ROADMAP Queue 1 item 16 (W8A8 pass 1)"),
)


def _check_ported(cfg: TrainConfig) -> None:
    for flag, item in _NOT_PORTED:
        if getattr(cfg, flag):
            raise NotImplementedError(f"TrainConfig.{flag}: not ported yet, {item}")
    if cfg.gradient_accumulation_steps > 1:
        raise NotImplementedError(
            "gradient_accumulation_steps > 1: not ported yet, ROADMAP Queue 1 "
            "item 12 (DDP and gradient accumulation)")


def partition_params(
    pipeline: DiffusionPipeline,
    tune_vae: bool = False,
    tune_text_encoder: bool = False,
) -> Dict[str, torch.nn.Parameter]:
    """Mark the trainable tensors of the pipeline and return them by name
    ("unet.<name>", "vae.<name>", "text.<name>"): the UNet's LoRA factors,
    and the VAE decoder or the text encoder with the flags of the same
    names. Every other parameter is set frozen (`requires_grad` off).

    A tensor of a bf16 tower stays bf16 here, the module's working copy;
    the optimizer keeps its fp32 master (`ClippedAdamW`). JAX's
    `tune_vae` also trains the VAE encoder, which the port does not have
    (ROADMAP Queue 3)."""
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
    updates the fp32 leaf, and the next forward casts it again. One
    difference: where a step uses a tensor twice (the text encoder runs
    on the prompts and on the null prompts), autograd sums the two bf16
    cotangents in bf16, JAX in fp32 after the casts.

    The clip is written as optax writes it: gradients are left as they are
    when their global norm is below `max_norm`, else divided by the norm
    and multiplied by `max_norm` (no epsilon, unlike
    `torch.nn.utils.clip_grad_norm_`). A trainable tensor without a
    gradient gets a zero one, so that weight decay reaches it as in optax.
    AdamW itself is `torch.optim.AdamW`: the same update as optax.adamw
    (bias-corrected moments, eps outside the square root, decoupled weight
    decay scaled by the learning rate)."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: TrainConfig,
                 initial_masters: Optional[Mapping[str, torch.Tensor]] = None):
        self.params = params
        self.max_norm = cfg.max_grad_norm
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
                self.masters[name] = master
        main = [m for n, m in self.masters.items() if not n.startswith("text.")]
        text = [m for n, m in self.masters.items() if n.startswith("text.")]
        groups = [{"params": main}]
        if text:
            groups.append({"params": text, "lr": cfg.textenc_lr
                           if cfg.textenc_lr is not None else cfg.learning_rate})
        self.adam = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=cfg.learning_rate,
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
            if master is not p:
                master.grad = (p.grad.float() if p.grad is not None
                               else torch.zeros_like(master))
            elif p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [m.grad for m in self.masters.values()]
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        if float(norm) >= self.max_norm:
            for g in grads:
                g.div_(norm).mul_(self.max_norm)
        self.adam.step()
        for name, p in self.params.items():
            if self.masters[name] is not p:
                p.copy_(self.masters[name])
        return norm


def make_optimizer(cfg: TrainConfig, params: Dict[str, torch.Tensor],
                   initial_masters: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> ClippedAdamW:
    _check_ported(cfg)
    return ClippedAdamW(params, cfg, initial_masters)


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
) -> TrainState:
    """`initial_masters`: fp32 tensors by trainable name ("vae.<name>",
    "text.<name>") that a bf16 tower's weights were rounded from, for a
    pipeline built from a JAX tree the tensors of
    `weights.from_jax_params` under their tower's prefix; without them the
    masters are the stored weights upcast (`ClippedAdamW`)."""
    trainable = partition_params(pipeline, tune_vae, tune_text_encoder)
    return TrainState(0, trainable, make_optimizer(cfg, trainable, initial_masters))


class StepDraws(NamedTuple):
    """The random inputs of one step."""

    latents0: torch.Tensor      # (B, h, w, 4)
    step_noise: torch.Tensor    # (S, B, h, w, 4)
    start: int                  # first trained step
    crop: Tuple[int, int]       # (offset_x, offset_y)


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
    latents, noise table, then the schedule start and the crop offsets."""
    device = generator.device if device is None else device
    shape = (batch, latent_size, latent_size, 4)
    latents0 = torch.randn(shape, generator=generator, device=generator.device)
    noise = torch.randn((cfg.total_step, *shape), generator=generator,
                        device=generator.device)
    offset_range = cfg.resolution // 224
    ints = torch.randint(0, 1 << 30, (3,), generator=generator,
                         device=generator.device).tolist()
    return StepDraws(
        latents0.to(device), noise.to(device), ints[0] % (max_start(cfg) + 1),
        (ints[1] % (offset_range + 1), ints[2] % (offset_range + 1)),
    )


class PhaseClock:
    """Marks on the device's timeline (CUDA events; host clock on the
    CPU), read after the step has synchronised."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: Dict[str, object] = {}

    def mark(self, name: str) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks[name] = event
        else:
            self.marks[name] = time.perf_counter()

    def seconds(self, a: str, b: str) -> float:
        ea, eb = self.marks[a], self.marks[b]
        if self.cuda:
            return ea.elapsed_time(eb) / 1e3
        return eb - ea


def make_loss_fn(pipeline: DiffusionPipeline, blip, cfg: TrainConfig,
                 extra_losses: Optional[Callable] = None, disc=None):
    """The differentiated quantity of a step.

    loss_fn(batch, draws, clock=None) -> (loss, (metrics, latents)).
    `batch` holds input_ids, null_ids, eos_positions (optional),
    caption_ids, caption_mask and caption_labels (numpy or tensors);
    `draws` a StepDraws. loss.backward() fills `.grad` of the trainable
    tensors. metrics: reward_blip, reward_total, reward_norm, step_loss
    (0-dim tensors)."""
    _check_ported(cfg)
    if extra_losses is not None:
        raise NotImplementedError(
            "extra_losses: not ported yet, ROADMAP Queue 1 item 10 (attrcon)")
    if disc is not None:
        raise NotImplementedError(
            "disc: not ported yet, ROADMAP Queue 1 item 9 (GAN)")

    def caption_loss_of_image(img, batch):
        r = blip_caption_reward(blip, img, batch["caption_ids"],
                                batch["caption_mask"], batch["caption_labels"])
        return -(cfg.reward_weight * r)

    def loss_fn(batch, draws: StepDraws, clock: Optional[PhaseClock] = None):
        mark = clock.mark if clock is not None else (lambda name: None)
        mark("start")
        trained_idx = sample_trained_idx(cfg, draws.start)
        image, result = pipeline.forward(
            batch["input_ids"], batch["null_ids"], trained_idx,
            num_inference_steps=cfg.total_step, K=cfg.K,
            guidance_scale=cfg.guidance_scale,
            guidance_rescale=cfg.guidance_rescale,
            eos_positions=batch.get("eos_positions"),
            train_text_encoder=cfg.train_text_encoder,
            latents0=draws.latents0, step_noise=draws.step_noise, mark=mark,
        )
        mark("decoded")
        if clock is not None and result.latents.requires_grad:
            # the gradient reaches the final latents when the decode's
            # backward ends and the replay's begins
            result.latents.register_hook(lambda g: mark("decode_backward"))

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
            "step_loss": loss.detach(),
        }
        return loss, (metrics, result.latents)

    return loss_fn


def make_train_step(pipeline: DiffusionPipeline, blip, cfg: TrainConfig,
                    extra_losses: Optional[Callable] = None, disc=None):
    """train_step(state, batch, draws=None, generator=None) ->
    (new state, metrics).

    `draws` are the step's random inputs; without them they are drawn
    from `generator`. metrics (Python floats): reward_blip, reward_total,
    reward_norm, step_loss, grad_norm (before the clip), and the seconds
    of the step's phases on its device: s_pass1 (encode and pass 1),
    s_pass2 (the replay, forward and backward), s_decode (forward and
    backward), s_reward (crop, BLIP forward and backward), s_optimizer,
    s_step."""
    loss_fn = make_loss_fn(pipeline, blip, cfg, extra_losses, disc)

    def train_step(state: TrainState, batch, draws: Optional[StepDraws] = None,
                   generator: Optional[torch.Generator] = None):
        if draws is None:
            draws = sample_draws(cfg, len(batch["input_ids"]),
                                 pipeline.cfg.latent_size, generator,
                                 pipeline.device)
        clock = PhaseClock(pipeline.device)
        state.optimizer.zero_grad()
        loss, (metrics, _) = loss_fn(batch, draws, clock)
        loss.backward()
        clock.mark("backward")
        grad_norm = state.optimizer.step()
        clock.mark("end")
        out = {k: float(v) for k, v in metrics.items()}
        out["grad_norm"] = float(grad_norm)
        sec = clock.seconds
        out["s_pass1"] = sec("start", "pass1")
        out["s_pass2"] = sec("pass1", "pass2") + sec("decode_backward", "backward")
        out["s_decode"] = sec("pass2", "decoded") + sec("reward", "decode_backward")
        out["s_reward"] = sec("decoded", "reward")
        out["s_optimizer"] = sec("backward", "end")
        out["s_step"] = sec("start", "end")
        return TrainState(state.step + 1, state.trainable, state.optimizer), out

    return train_step
