"""Trainer: the CoMat recipe end to end on one device.

The port's counterpart of comat_tpu/training/trainer.py (reference:
training_script.py's Trainer), single card. Construction follows the
reference's order: logger -> smoke gates -> pipeline -> caption model ->
train state -> discriminator -> data -> resume -> attribute
concentration. `train()` runs the loop: validation and a checkpoint at
step 0, one `make_train_step` step per batch with its draws from one
`torch.Generator` seeded by --seed, metrics one step late, checkpoints
and validation every --validation_steps and at the end, and a checkpoint
before exiting on SIGTERM/SIGINT. With an image-dependent segmenter
(--seg_model gsam: Grounded-SAM, seeded unless its checkpoints are given)
each step is split as in JAX: the no-grad presample, the segmentation of
its images on the device, then the step replaying the presample's tables.

Weights are drawn from --seed; loading a diffusers snapshot is not ported
(ROADMAP Queue 1: snapshot loaders), so an existing --pretrain_model
directory raises, and a missing one warns and starts from random weights,
as JAX does. Real runs refuse the smoke fallbacks (hash tokenizers,
random caption weights, zero GAN latents) unless --allow_smoke.
"""

from __future__ import annotations

import math
import os
import signal
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from comat_tpu_torch.config import BLIPConfig
from comat_tpu_torch.losses.gan import Discriminator, GanConfig
from comat_tpu_torch.models.blip import make_blip
from comat_tpu_torch.models.pipeline import (
    DiffusionPipeline,
    make_pipeline_config,
    resolve_device,
)
from comat_tpu_torch.text.tokenizer import HashTokenizer, load_clip_tokenizer
from comat_tpu_torch.training import checkpoints as ckpt_lib
from comat_tpu_torch.training.data import (
    GanLatentStore,
    PromptDataset,
    assemble_batch,
    load_prompts,
)
from comat_tpu_torch.training.logging_utils import MetricsWriter, StepTimer, set_logger
from comat_tpu_torch.training.train_step import (
    SEGMENTS,
    PhaseClock,
    TrainConfig,
    init_disc_state,
    init_train_state,
    make_presample,
    make_train_step,
    sample_draws,
)

_LOADERS = "ROADMAP Queue 1: snapshot loaders, tested on synthetic snapshots"


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: constant `init` when steps <= 0."""
    if steps <= 0:
        return lambda count: init

    def f(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return f


def _cosine(init: float, decay_steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with alpha 0."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")
    return lambda count: init * 0.5 * (1 + math.cos(math.pi * min(count, decay_steps)
                                                    / decay_steps))


def _join(first: Callable, second: Callable, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules of two schedules."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def lr_schedule(args) -> Callable[[int], float]:
    """The learning rate at each update count: JAX's `_lr_schedule`
    (comat_tpu/training/trainer.py:60-87), optax's schedules in fp64:
    constant (a linear warmup from 0 over --lr_warmup_steps when given),
    cosine (warmup, then cosine decay to 0 at --max_train_steps) and
    linear (warmup, then linear decay to 0)."""
    lr, warm, total = args.learning_rate, args.lr_warmup_steps, args.max_train_steps
    if args.lr_scheduler == "constant":
        return _linear(0.0, lr, warm) if warm else (lambda count: lr)
    if args.lr_scheduler == "cosine":
        return _join(_linear(0.0, lr, warm), _cosine(lr, total - warm), warm)
    if args.lr_scheduler == "linear":
        return _join(_linear(0.0, lr, warm), _linear(lr, 0.0, total - warm), warm)
    raise ValueError(f"unknown lr_scheduler {args.lr_scheduler!r}")


def resolve_snapshot(path: Optional[str], cache_dir: Optional[str]) -> Optional[str]:
    """A HF repo id resolved against --cache_dir's hub layout
    (cache_dir/models--org--name/snapshots/<rev>) or a plain
    cache_dir/name directory; a local path as it is (JAX's
    `Trainer._resolve_snapshot`)."""
    if not path or os.path.isdir(path) or not cache_dir:
        return path
    for c in (os.path.join(cache_dir, "models--" + path.replace("/", "--"), "snapshots"),
              os.path.join(cache_dir, path.split("/")[-1]),
              os.path.join(cache_dir, path)):
        if not os.path.isdir(c):
            continue
        if not c.endswith("snapshots"):
            return c
        ref = os.path.join(os.path.dirname(c), "refs", "main")
        if os.path.isfile(ref):
            with open(ref) as f:
                rev = os.path.join(c, f.read().strip())
            if os.path.isdir(rev):
                return rev
        revs = [os.path.join(c, r) for r in os.listdir(c)
                if os.path.isdir(os.path.join(c, r))]
        if revs:
            return max(revs, key=os.path.getmtime)
    return path


class Trainer:
    """`probe`: called at each mark of every step's PhaseClock (e.g. to
    read kernel launch counters); the differences it reads are summed
    per segment of the step (`train_step.SEGMENTS`) in `segment_counts`."""

    def __init__(self, args, probe: Optional[Callable[[], Dict[str, int]]] = None):
        self.args = args
        self.probe = probe
        self.segment_counts: Dict[str, Dict[str, int]] = {}
        self.device = resolve_device(args.device)
        self.logger = set_logger(args.output_dir)
        tiny = bool(args.tiny_models)
        self.logger.info("building pipeline %s on %s", args.pretrain_model_name,
                         self.device)
        self.pcfg = make_pipeline_config(args.pretrain_model_name,
                                         lora_rank=args.lora_rank,
                                         resolution=args.resolution, tiny=tiny)
        self.blip_cfg = BLIPConfig.tiny() if tiny else BLIPConfig.large()
        self.tcfg = TrainConfig(
            total_step=args.total_step, K=args.K, guidance_scale=args.cfg_scale,
            guidance_rescale=args.cfg_rescale, resolution=args.resolution,
            reward_weight=args.reward_weights[0], learning_rate=args.learning_rate,
            adam_b1=args.adam_beta1, adam_b2=args.adam_beta2,
            adam_eps=args.adam_epsilon, adam_weight_decay=args.adam_weight_decay,
            max_grad_norm=args.max_grad_norm, norm_grad=args.norm_grad,
            train_text_encoder=args.tune_text_encoder,
            gan_loss=args.gan_loss, gan_loss_weight=args.gan_loss_weight,
            attrcon="attrcon" in args.pretrain_model_name,
            attrcon_train_steps=args.attrcon_train_steps,
            mask_token_loss_weight=args.mask_token_loss_weight,
            mask_pixel_loss_weight=args.mask_pixel_loss_weight,
            gradient_accumulation_steps=args.gradient_accumulation_steps,
            gradient_checkpointing=args.gradient_checkpointing,
            remat_min_res=args.remat_min_res,
            textenc_lr=args.textenc_lora_lr if args.tune_text_encoder else None,
        )

        # cheap checks first, before any weights are made
        if not tiny:
            self._smoke_gate(
                "caption-model weights are not loaded (ROADMAP Queue 1: snapshot "
                "loaders): the concept-matching reward would score with a "
                "random-weight BLIP")
        if args.gan_loss and not args.gan_gt_path and not tiny:
            self._smoke_gate(
                "--gan_loss without --gan_gt_path: the discriminator would train "
                "against all-zero GT latents")
        if tiny:
            self.clip_tok = HashTokenizer(self.pcfg.text.vocab_size)
            self.caption_tok = HashTokenizer(self.blip_cfg.vocab_size)
        else:
            self.clip_tok = load_clip_tokenizer(args.tokenizer_dir)
            if isinstance(self.clip_tok, HashTokenizer):
                self._smoke_gate(
                    "no CLIP tokenizer files found (--tokenizer_dir); a "
                    "HashTokenizer would feed garbage ids to real text-encoder "
                    "weights")
            self._smoke_gate("no --blip_tokenizer_vocab: the caption reward "
                             "would tokenize with a HashTokenizer")
            self.caption_tok = HashTokenizer(self.blip_cfg.vocab_size)
        weights = resolve_snapshot(args.pretrain_model, args.cache_dir)
        if weights and os.path.isdir(weights):
            raise NotImplementedError(
                f"--pretrain_model {weights}: loading a snapshot is not ported yet, "
                f"{_LOADERS}")
        self.logger.warning("pretrained weights unavailable at %r; random init",
                            weights)

        if args.max_train_steps is None:
            # from --num_train_epochs before the schedule needs the horizon
            # (reference training_script.py:287-288)
            n = len(load_prompts(args.training_prompts, args.max_train_samples))
            args.max_train_steps = args.num_train_epochs * max(
                1, n // max(1, args.train_batch_size))
        self.lr_fn = lr_schedule(args)
        if args.allow_tf32:
            torch.backends.cuda.matmul.allow_tf32 = True

        seed = args.seed if args.seed is not None else 0
        self.pipeline = DiffusionPipeline(self.pcfg, self.device, seed=seed,
                                          fuse_pass1=not args.gradient_checkpointing)
        self.blip = make_blip(self.blip_cfg, self.device, seed=seed + 1)
        self.state = init_train_state(self.pipeline, self.tcfg, tune_vae=args.tune_vae,
                                      tune_text_encoder=args.tune_text_encoder,
                                      lr_schedule=self.lr_fn)

        self.disc = self.d_state = self.latent_store = None
        if args.gan_loss:
            # the reference strips a 'gan' prefix (gan_sd_model.py:9-13)
            d_arch = (args.gan_model_arch or "sd_1_5").replace("gan", "")
            if d_arch.startswith("sdxl"):
                raise NotImplementedError(
                    f"--gan_model_arch {args.gan_model_arch}: not ported yet, "
                    "ROADMAP Queue 1: SDXL")
            # D's frozen base is the generator's own UNet (gan_sd_model.py:8-13)
            self.disc = Discriminator(
                self.pcfg.unet, GanConfig(lora_rank=args.lora_rank,
                                          lastlayer_cls=args.gan_unet_lastlayer_cls,
                                          condition_discriminator=args.condition_discriminator),
                self.device, base_unet=self.pipeline.unet, seed=seed + 2)
            self.d_state = init_disc_state(
                self.disc, self.tcfg, lr=args.learning_rate_D, b1=args.adam_beta1_D,
                b2=args.adam_beta2_D, max_grad_norm=args.max_grad_norm_D)
            if args.gan_gt_path:
                self.latent_store = GanLatentStore(args.gan_gt_path)

        prompts = load_prompts(args.training_prompts, args.max_train_samples)
        self.dataset = PromptDataset(prompts, args.train_batch_size, seed=seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        # resume (reference training_script.py:156-205)
        self.global_step = 0
        if args.resume_from_checkpoint:
            path = args.resume_from_checkpoint
            if path == "latest":
                path = ckpt_lib.latest_checkpoint(args.output_dir)
            if path:
                self.global_step, extra = ckpt_lib.restore_checkpoint(
                    path, self.state, self.d_state, self.generator)
                self.state = self.state._replace(step=self.global_step)
                if self.latent_store is not None and "latent_store_rng" in extra:
                    self.latent_store.rng.setstate(extra["latent_store_rng"])
                self.logger.info("resumed from %s (step %d)", path, self.global_step)

        self.seg_holder = None
        extra_losses = None
        if self.tcfg.attrcon:
            from comat_tpu_torch.segmentation.interface import (
                CenterPriorSegmenter, PrecomputedMaskSegmenter, SegmenterHolder,
            )
            from comat_tpu_torch.training.attrcon import make_attrcon_extra_losses

            if args.parse_cache:
                from comat_tpu_torch.text.parse_cache import (
                    load_parse_cache, set_parse_cache,
                )

                set_parse_cache(load_parse_cache(args.parse_cache))
                self.logger.info("parse cache armed: %s", args.parse_cache)
            if args.precomputed_masks:
                segmenter = PrecomputedMaskSegmenter(args.precomputed_masks)
            elif args.seg_model == "gsam" and not tiny:
                segmenter = self._build_gsam_segmenter(args, seed)
            else:
                # --tiny_models or another --seg_model: the center prior keeps
                # the loss path exercised, as in JAX
                segmenter = CenterPriorSegmenter()
            self.seg_holder = SegmenterHolder(segmenter)
            extra_losses = make_attrcon_extra_losses(self.pipeline, self.seg_holder,
                                                     self.tcfg)
        self.train_step = make_train_step(
            self.pipeline, self.blip, self.tcfg, extra_losses, self.disc,
            self.d_state.optimizer if self.d_state is not None else None)
        # an image-dependent segmenter (Grounded-SAM) needs the generated
        # image: each step is split into the presample, the segmentation and
        # the differentiable step replaying the presample's tables
        self.presample = None
        if self.seg_holder is not None and self.seg_holder.image_dependent:
            self.presample = make_presample(self.pipeline, self.tcfg)

        self.metrics = MetricsWriter(args.output_dir)
        self.timer = StepTimer()
        self._pending_metrics = None
        self._profiler = None
        self._step_times = []
        # (step, seconds) of each validation, its images fetched included
        self.validation_times = []
        # SIGTERM/SIGINT: checkpoint, then exit (the reference has none)
        self._stop_requested = False

        def _graceful(signum, frame):
            self.logger.warning("signal %d: checkpointing at step %d then exiting",
                                signum, self.global_step)
            self._stop_requested = True

        try:
            signal.signal(signal.SIGTERM, _graceful)
            signal.signal(signal.SIGINT, _graceful)
        except ValueError:
            pass    # not the main thread

    def _build_gsam_segmenter(self, args, seed: int):
        """The reference's default segmenter (--seg_model gsam): FastSAM-x
        proposals and GroundingDINO-T (swint_ogc) grounding at an 800-pixel
        input (attr_concen_utils/gsam_interface.py), on the trainer's device.
        Weights load from --fastsam_checkpoint / --gdino_checkpoint, the
        tokenizer from --gdino_tokenizer_vocab; without them the stack runs
        all the same, with seeded weights (the masks are noise) or the hash
        tokenizer, and says so (JAX's `_build_gsam_segmenter`)."""
        from comat_tpu_torch.segmentation import checkpoints as seg_ckpt
        from comat_tpu_torch.segmentation.grounded_sam import GroundedSAMSegmenter

        tok = None
        if args.gdino_tokenizer_vocab:
            from comat_tpu_torch.text.tokenizer import BertWordPieceTokenizer

            tok = BertWordPieceTokenizer(args.gdino_tokenizer_vocab)
        seg = GroundedSAMSegmenter(tokenizer=tok, device=self.device, seed=seed + 3,
                                   gdino_resize=800)   # the reference's RandomResize([800])
        loaded = []
        for name, path, load, module in (
                ("fastsam", args.fastsam_checkpoint, seg_ckpt.load_fastsam_checkpoint, seg.sam),
                ("gdino", args.gdino_checkpoint, seg_ckpt.load_gdino_checkpoint, seg.gdino)):
            if not path:
                continue
            missing, unused = load(path, module)
            if missing or unused:
                self.logger.warning("%s import: %d tensors missing (first: %s), %d unused "
                                    "(first: %s)", name, len(missing), missing[:3],
                                    len(unused), unused[:3])
            loaded.append(name)
        if len(loaded) < 2:
            self.logger.warning(
                "GroundedSAM running with RANDOM weights for %s: masks will be noise. "
                "Pass --fastsam_checkpoint / --gdino_checkpoint for real segmentation.",
                sorted({"fastsam", "gdino"} - set(loaded)))
        if tok is None:
            self.logger.warning("no --gdino_tokenizer_vocab: GroundingDINO tokenizes the "
                                "nouns with a HashTokenizer")
        return seg

    def _smoke_gate(self, why: str) -> None:
        """Refuse a fidelity-degrading fallback in a real (non-tiny) run
        unless --allow_smoke."""
        if self.args.allow_smoke:
            self.logger.warning("SMOKE MODE: %s", why)
            return
        raise RuntimeError(f"refusing to continue: {why}. Pass --allow_smoke to run "
                           "anyway (smoke testing only).")

    # ---- loop ----
    def _batch(self, prompts):
        batch = assemble_batch(prompts, self.clip_tok, self.caption_tok,
                               max_length=self.pcfg.text.max_length,
                               latent_store=self.latent_store)
        if self.seg_holder is not None:
            from comat_tpu_torch.training.attrcon import attrcon_batch_fields

            batch.update(attrcon_batch_fields(prompts, self.clip_tok, self.seg_holder,
                                              self.pcfg.text.max_length,
                                              resolution=self.args.resolution))
        if self.disc is not None and "gt_latents" not in batch:
            # GAN without a latent store: zeros as GT (gated above)
            s = self.pcfg.latent_size
            batch["gt_latents"] = np.zeros((len(prompts), s, s, 4), np.float32)
        return batch

    def train(self) -> None:
        args = self.args
        steps_per_epoch = max(len(self.dataset), 1)
        num_epochs = max(1, -(-args.max_train_steps // steps_per_epoch))
        self.logger.info("training: %d steps, %d/epoch, %d epochs",
                         args.max_train_steps, steps_per_epoch, num_epochs)
        # resume fast-forward (reference training_script.py:544-548):
        # restart inside the checkpoint's epoch, skipping its used batches
        resumed = bool(args.resume_from_checkpoint) and self.global_step > 0
        first_epoch = self.global_step // steps_per_epoch
        resume_skip = self.global_step % steps_per_epoch
        if self.global_step == 0:
            self.save_and_evaluate()   # evaluate before training (:497-502)
        elif resumed and self.global_step % 100 == 0:
            # eval-only after a resume, on the reference's hardcoded
            # step % 100 (training_script.py:504), not --validation_steps
            self.save_and_evaluate(save=False)
        for epoch in range(first_epoch, num_epochs):
            for step_in_epoch, prompts in enumerate(self.dataset.epoch(epoch)):
                if resumed and epoch == first_epoch and step_in_epoch < resume_skip:
                    continue
                if self.global_step >= args.max_train_steps:
                    break
                if args.batch_repeat > 1:
                    prompts = list(prompts) * args.batch_repeat
                clock = PhaseClock(self.device, probe=self.probe)
                batch = self._batch(prompts)
                self.timer.tick()
                draws = None
                if self.presample is not None:
                    # the split step (JAX trainer.py:785-798): the step's
                    # draws, taken from the generator as the step takes them
                    draws = sample_draws(self.tcfg, len(prompts), self.pcfg.latent_size,
                                         self.generator, self.device)
                    image, eps_table, traj = self.presample(batch, draws, clock)
                    batch["seg_masks"] = self.seg_holder.device_masks(image, mark=clock.mark)
                    batch["eps_table"], batch["latents_traj"] = eps_table, traj
                # the step returns host floats, so it has synchronised
                self.state, m = self.train_step(self.state, batch, draws=draws,
                                                generator=self.generator, clock=clock)
                dt = self.timer.tick()
                self.global_step += 1
                if self.probe is not None:
                    self._add_counts(clock)
                self._profile_step()
                self._flush_pending_metrics()
                self._pending_metrics = (self.global_step, m, len(prompts), dt)
                if self._stop_requested:
                    self._flush_pending_metrics()
                    self.save_and_evaluate()
                    self.logger.info("exiting on signal after checkpoint")
                    return
                if args.validation_steps and self.global_step % args.validation_steps == 0:
                    self.save_and_evaluate()
            if self.global_step >= args.max_train_steps:
                break
        self._flush_pending_metrics()
        self.save_and_evaluate()

    def _add_counts(self, clock: PhaseClock) -> None:
        for seg, marks in SEGMENTS.items():
            acc = self.segment_counts.setdefault(seg, {})
            for k, n in clock.counts(*marks).items():
                acc[k] = acc.get(k, 0) + n

    def _profile_step(self) -> None:
        """--profile_dir: a torch.profiler trace of steps 4-7, written as
        `<profile_dir>/trace.json` (chrome trace)."""
        if not self.args.profile_dir:
            return
        if self.global_step == 4 and self._profiler is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.start()
        elif self.global_step == 8 and self._profiler is not None:
            self._profiler.stop()
            os.makedirs(self.args.profile_dir, exist_ok=True)
            path = os.path.join(self.args.profile_dir, "trace.json")
            self._profiler.export_chrome_trace(path)
            self._profiler = None
            self.logger.info("profile written to %s", path)

    def _flush_pending_metrics(self) -> None:
        """Log the previous step's metrics (one step late, as JAX logs
        them) and feed the straggler watchdog. `sec_per_step` is the
        step's own wall time; JAX's is the time between two logging calls,
        which in the port would be the next step's."""
        if self._pending_metrics is None:
            return
        pstep, pm, pbs, dt = self._pending_metrics
        self._pending_metrics = None
        host_m = dict(pm)
        # the reference's per-step keys (training_script.py:667-703); lr
        # as JAX logs it, the schedule at the step count after the update
        host_m["train_loss"] = host_m.get("step_loss", 0.0)
        host_m["lr"] = float(self.lr_fn(pstep))
        host_m["sec_per_step"] = dt
        if dt > 0:
            host_m["images_per_sec"] = pbs / dt
        self.metrics.log(host_m, pstep)
        self.logger.info("step %d: loss=%.4f reward=%.4f", pstep,
                         host_m.get("step_loss", 0.0), host_m.get("reward_blip", 0.0))
        if dt > 0:
            self._step_times.append(dt)
            hist = self._step_times[-50:]
            med = sorted(hist)[len(hist) // 2]
            if len(hist) >= 5 and dt > 3.0 * med:
                self.logger.warning("step %d took %.1fs (median %.1fs): possible "
                                    "straggler", pstep, dt, med)

    def save_and_evaluate(self, save: bool = True) -> None:
        """Checkpoint, LoRA export and validation images (reference
        training_script.py:382-494; save=False is the eval-only mode
        after a resume, :504-509)."""
        args = self.args
        if save:
            extra = ({"latent_store_rng": self.latent_store.rng.getstate()}
                     if self.latent_store is not None else {})
            path = ckpt_lib.save_checkpoint(
                args.output_dir, self.global_step, self.state, self.d_state,
                self.generator, extra, total_limit=args.checkpoints_total_limit)
            # the reference's artifact name, loadable by diffusers'
            # LoraLoaderMixin (training_script.py:397-401)
            ckpt_lib.export_lora_safetensors(
                os.path.join(path, "pytorch_lora_weights.safetensors"),
                self.state.trainable)
            self.logger.info("saved checkpoint %s", path)
        if ((args.validation_prompts or args.validation_prompts_file)
                and args.num_validation_images > 0):
            self._validate()

    def _validate(self) -> None:
        """Every validation prompt at the full step count, one prompt at a
        time, for --num_validation_images rounds (training_script.py:
        456-489); --tiny_models caps the prompts at 4 and the steps at 25.
        The scheduler follows --scheduler (DPM++ or DDPM, :441-454). One
        fused UNet samples every prompt and round, and goes when it ends."""
        t0 = time.perf_counter()
        args = self.args
        vp = args.validation_prompts or []
        if len(vp) == 1 and os.path.isfile(vp[0]):
            prompts = load_prompts(vp[0])
        else:
            prompts = list(vp)
        if args.validation_prompts_file:
            prompts = prompts + load_prompts(args.validation_prompts_file)
        prompts = [p.strip() for p in prompts if p.strip()]
        tiny = bool(args.tiny_models)
        if tiny:
            prompts = prompts[:4]
        n_steps = min(args.total_step, 25) if tiny else args.total_step
        L = self.pcfg.text.max_length
        enc = self.clip_tok(prompts, max_length=L)
        null = self.clip_tok([""], max_length=L)
        kind = "dpmpp" if args.scheduler == "DPM++" else "ddpm"
        seed = args.seed if args.seed is not None else 0
        unet = self.pipeline.fused_unet()
        for r in range(args.num_validation_images):
            rows = []
            for i in range(len(prompts)):
                g = torch.Generator(device=self.device).manual_seed(
                    seed + r * 100003 + i)
                img = self.pipeline.generate(
                    enc["input_ids"][i:i + 1], null["input_ids"],
                    num_inference_steps=n_steps, guidance_scale=args.cfg_scale,
                    guidance_rescale=args.cfg_rescale,
                    eos_positions=enc["eos_positions"][i:i + 1], kind=kind,
                    generator=g, unet=unet)
                rows.append(img[0].float().cpu().numpy())
            self.metrics.log_images(f"validation_{r}", np.stack(rows), self.global_step)
        dt = time.perf_counter() - t0
        self.validation_times.append((self.global_step, dt))
        self.logger.info("validation at step %d: %d prompts x %d rounds, %.3f s",
                         self.global_step, len(prompts), args.num_validation_images, dt)
