"""Trainer: the CoMat recipe end to end, on one card or one process a card.

The port's counterpart of comat_tpu/training/trainer.py (reference:
training_script.py's Trainer). Construction follows the reference's
order: logger -> smoke gates -> pipeline -> caption model -> train state
-> discriminator -> data -> resume -> attribute concentration.

Under a process group (`torchrun`, see `parallel.mesh.init_distributed`)
the ranks form a (world / --mesh_model_axis, --mesh_model_axis) mesh as
JAX's trainer does: the device is cuda:LOCAL_RANK, --train_batch_size is
per card, the prompts are split by data index (the ranks of one model
group see the same rows: --mesh_model_axis M makes M replicas of each
data shard's computation, as in JAX, whose trainer never applies
`parallel.tp`), and the step sums its loss shares and gradients over the
data groups (`make_train_step(mesh=)`). Rank 0's trained tensors are
broadcast at start. With Grounded-SAM the first rank of each model group
segments its rows and broadcasts the masks to its group. Rank 0 alone
writes log.txt, metrics.jsonl, the TensorBoard log, the checkpoints
(every rank's latent-store state gathered into them), the LoRA export and
the validation images, and a barrier follows each checkpoint; every rank
restores on resume. A stop signal on any rank stops every rank after the
same step.

`train()` runs the loop: validation and a checkpoint at step 0, one
`make_train_step` step per batch with its draws from one
`torch.Generator` seeded by --seed, metrics one step late, checkpoints
and validation every --validation_steps and at the end, and a checkpoint
before exiting on SIGTERM/SIGINT. Under --gradient_accumulation_steps N
the generator's update applies on every N-th step (`ClippedAdamW`, JAX's
`optax.MultiSteps`) while D updates every step; `global_step`,
--max_train_steps, --validation_steps and the checkpoints count steps
(micro-steps), as JAX's trainer counts them, and a checkpoint holds the
running mean of the gradients, so a resume between two updates ends as
the uninterrupted run. Metrics go to metrics.jsonl and, with --report_to
tensorboard (the default), to a TensorBoard log in
`<output_dir>/<logging_dir>`. With an image-dependent segmenter
(--seg_model gsam: Grounded-SAM, seeded unless its checkpoints are given)
each step is split as in JAX: the no-grad presample, the segmentation of
its images on the device, then the step replaying the presample's tables.

SD1.5 and SDXL (`--pretrain_model_name sdxl*`: both text towers, the
second tokenizer padding with id 0, the added condition). Under an SDXL
generator `--gan_model_arch gansd_1_5` builds the published recipe's
cross-architecture D, an SD1.5 UNet of its own (seeded) conditioned on
CLIP-L's final states; `--gan_model_arch sdxl` an SDXL D sharing the
generator's base, as with SD1.5. Under --full_finetuning D takes a frozen
copy of the generator's base instead, so that it stays at the pretrained
weights while the generator's moves (JAX's `_share_base_unet`).

Trainable surfaces as JAX's trainer sets them: the UNet's LoRA, plus
--train_text_encoder_lora (LoRA of --lora_rank on both text towers),
--tune_text_encoder (both text towers whole), --tune_vae and
--full_finetuning (the whole UNet); either text flag turns the text
towers' gradient on and --textenc_lora_lr's rate group. --use_8bit_adam
keeps the generator's AdamW moments as int8 blocks (`training.optim8bit`).

Weights: the towers load from the diffusers snapshot --pretrain_model
names (a folder, or a repo id resolved through --cache_dir's hub cache),
in place over weights drawn from --seed; `--sdxl_unet_path` (a diffusers
UNet .safetensors or folder) swaps in a UNet over them; the caption model
loads from --caption_model_path, else from the reference's
Salesforce/blip-image-captioning-large resolved through --cache_dir, and
its tokenizer from --blip_tokenizer_vocab (`models/hf_import.py`). The
file sets are chosen before any weights are made, so a folder without
safetensors raises at once. With --tune_vae / --tune_text_encoder the
trained bf16 towers' fp32 masters are the snapshot's values, as JAX's
fp32 leaves are (and the UNet's under --full_finetuning). A
cross-architecture D keeps its seeded SD1.5 tower, as
in JAX. Real runs refuse the smoke fallbacks (seeded tower or caption
weights, tensors a snapshot lacks, hash tokenizers, zero GAN latents)
unless --allow_smoke (`smoke_fallbacks` lists those taken); a snapshot
that lacks a tower's tensors is refused at --tiny_models too.

Host pieces, where JAX's trainer takes its native ones: with
--tokenizer_dir holding vocab.json and merges.txt the CLIP tokenizer is
`native_host.NativeCLIPTokenizer` (at --tiny_models too, an explicit
vocabulary being read there as --blip_tokenizer_vocab is; SDXL's second
tokenizer stays `CLIPBPETokenizer`), and with --gan_gt_path the latent
store is `native_host.NativeLatentStore` when every index entry is a .npy
file, else `GanLatentStore` (one log line names the file that decided).
Both give the Python pieces' ids and latents, so a step is the same bit
for bit either way.
"""

from __future__ import annotations

import math
import os
import signal
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from comat_tpu_torch.config import BLIPConfig, UNetConfig
from comat_tpu_torch.losses.gan import Discriminator, GanConfig
from comat_tpu_torch.models.blip import make_blip
from comat_tpu_torch.models.hf_import import (
    CAPTION_MODEL_ID,
    SNAPSHOT_TOWERS,
    LoadReport,
    load_blip_state,
    load_sd_state,
    load_unet_state,
    resolve_snapshot,
    safetensors_files,
)
from comat_tpu_torch.models.pipeline import (
    DiffusionPipeline,
    make_pipeline_config,
    resolve_device,
)
from comat_tpu_torch.native_host import NativeCLIPTokenizer, NativeLatentStore
from comat_tpu_torch.text.tokenizer import (
    BertWordPieceTokenizer,
    HashTokenizer,
    load_clip_tokenizer,
)
from comat_tpu_torch.parallel import mesh as mesh_lib
from comat_tpu_torch.training import checkpoints as ckpt_lib
from comat_tpu_torch.training.data import (
    GanLatentStore,
    PromptDataset,
    assemble_batch,
    load_prompts,
    read_latent_index,
)
from comat_tpu_torch.training.logging_utils import MetricsWriter, set_logger
from comat_tpu_torch.training.profile import write_profile
from comat_tpu_torch.training.train_step import (
    SEGMENTS,
    PhaseClock,
    TrainConfig,
    init_disc_state,
    init_train_state,
    local_draws,
    make_presample,
    make_train_step,
    sample_draws,
)


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


class Trainer:
    """`probe`: called at each mark of every step's PhaseClock (e.g. to
    read kernel launch counters); the differences it reads are summed
    per segment of the step (`train_step.SEGMENTS`) in `segment_counts`."""

    def __init__(self, args, probe: Optional[Callable[[], Dict[str, int]]] = None):
        self.args = args
        self.probe = probe
        self.segment_counts: Dict[str, Dict[str, int]] = {}
        # the mesh of the process group, before any weights: every rank
        # makes its subgroups in the same order
        self.mesh = None
        device = args.device
        if torch.distributed.is_initialized() or args.mesh_model_axis > 1:
            self.mesh = mesh_lib.make_mesh(model=args.mesh_model_axis)
            if device == "cuda":
                device = f"cuda:{os.environ.get('LOCAL_RANK', '0')}"
        self.rank = self.mesh.rank if self.mesh is not None else 0
        self.data_groups = self.mesh.data if self.mesh is not None else 1
        self.device = resolve_device(device)
        self.logger = set_logger(args.output_dir,
                                 self.rank if self.mesh is not None else None)
        tiny = bool(args.tiny_models)
        self.logger.info("building pipeline %s on %s", args.pretrain_model_name,
                         self.device)
        self.pcfg = make_pipeline_config(
            args.pretrain_model_name, lora_rank=args.lora_rank,
            resolution=args.resolution, tiny=tiny,
            text_lora_rank=args.lora_rank if args.train_text_encoder_lora else 0,
            # --prediction_type: None is the model's own, epsilon for SD1.5/SDXL
            prediction_type=args.prediction_type or "epsilon")
        train_text = args.tune_text_encoder or args.train_text_encoder_lora
        self.blip_cfg = BLIPConfig.tiny() if tiny else BLIPConfig.large()
        self.tcfg = TrainConfig(
            total_step=args.total_step, K=args.K, guidance_scale=args.cfg_scale,
            guidance_rescale=args.cfg_rescale, resolution=args.resolution,
            reward_weight=args.reward_weights[0], learning_rate=args.learning_rate,
            adam_b1=args.adam_beta1, adam_b2=args.adam_beta2,
            adam_eps=args.adam_epsilon, adam_weight_decay=args.adam_weight_decay,
            max_grad_norm=args.max_grad_norm, norm_grad=args.norm_grad,
            train_text_encoder=train_text,
            gan_loss=args.gan_loss, gan_loss_weight=args.gan_loss_weight,
            attrcon="attrcon" in args.pretrain_model_name,
            attrcon_train_steps=args.attrcon_train_steps,
            mask_token_loss_weight=args.mask_token_loss_weight,
            mask_pixel_loss_weight=args.mask_pixel_loss_weight,
            gradient_accumulation_steps=args.gradient_accumulation_steps,
            use_8bit_adam=args.use_8bit_adam,
            gradient_checkpointing=args.gradient_checkpointing,
            remat_min_res=args.remat_min_res,
            pass1_int8=args.pass1_int8,
            textenc_lr=args.textenc_lora_lr if train_text else None,
        )

        # cheap checks first, before any weights are made
        # (kind, why) of each smoke fallback taken under --allow_smoke
        self.smoke_fallbacks: List[Tuple[str, str]] = []
        self.snapshot = self._resolve_pretrained(tiny)
        self.caption_dir = self._resolve_caption_weights(tiny)
        if args.gan_loss and not args.gan_gt_path and not tiny:
            self._smoke_gate(
                "--gan_loss without --gan_gt_path: the discriminator would train "
                "against all-zero GT latents", kind="data")
        clip_files = [os.path.join(args.tokenizer_dir or "", f)
                      for f in ("vocab.json", "merges.txt")]
        if args.tokenizer_dir and all(os.path.isfile(f) for f in clip_files):
            self.clip_tok = NativeCLIPTokenizer(*clip_files)
        elif tiny:
            self.clip_tok = HashTokenizer(self.pcfg.text.vocab_size)
        else:
            self.clip_tok = load_clip_tokenizer(args.tokenizer_dir)
            if isinstance(self.clip_tok, HashTokenizer):
                self._smoke_gate(
                    "no CLIP tokenizer files found (--tokenizer_dir); a "
                    "HashTokenizer would feed garbage ids to real text-encoder "
                    "weights", kind="tokenizer")
        if args.blip_tokenizer_vocab:
            # an explicit vocabulary is read at --tiny_models too
            self.caption_tok = BertWordPieceTokenizer(args.blip_tokenizer_vocab)
        else:
            if not tiny:
                self._smoke_gate("no --blip_tokenizer_vocab: the caption reward "
                                 "would tokenize with a HashTokenizer", kind="tokenizer")
            self.caption_tok = HashTokenizer(self.blip_cfg.vocab_size)
        # SDXL's second tokenizer (reference AttrConcenTrainableSDXLPipeline.py:
        # 21-22): CLIP-L's BPE, padding with "!" (id 0), so that the bigG
        # tower sees its own padded ids
        self.clip_tok2 = None
        if self.pcfg.is_sdxl:
            self.clip_tok2 = (
                HashTokenizer(self.pcfg.text.vocab_size, pad_token_id=0) if tiny
                else load_clip_tokenizer(args.tokenizer2_dir or args.tokenizer_dir,
                                         pad_token_id=0))

        if args.max_train_steps is None:
            # from --num_train_epochs before the schedule needs the horizon
            # (reference training_script.py:287-288)
            n = len(load_prompts(args.training_prompts, args.max_train_samples))
            args.max_train_steps = args.num_train_epochs * max(
                1, n // max(1, args.train_batch_size * self.data_groups))
        self.lr_fn = lr_schedule(args)
        if args.allow_tf32:
            torch.backends.cuda.matmul.allow_tf32 = True

        seed = args.seed if args.seed is not None else 0
        self.pipeline = DiffusionPipeline(self.pcfg, self.device, seed=seed,
                                          fuse_pass1=not args.gradient_checkpointing)
        # in place, before the train state and D exist: the masters of a
        # trained bf16 tower are the snapshot's fp32 values
        self.load_reports: Dict[str, LoadReport] = {}
        masters = self._load_pretrained(args)
        self.blip = make_blip(self.blip_cfg, self.device, seed=seed + 1)
        if self.caption_dir:
            report = self._record_load("caption_model", self.caption_dir,
                                       load_blip_state(self.caption_dir, self.blip))
            self._gate_missing("caption model", self.caption_dir, report.missing)
        self.state = init_train_state(self.pipeline, self.tcfg, tune_vae=args.tune_vae,
                                      tune_text_encoder=args.tune_text_encoder,
                                      initial_masters=masters, lr_schedule=self.lr_fn,
                                      full_finetuning=args.full_finetuning)
        # the optimizer holds its own masters: the load's fp32 copies go
        del masters
        for report in self.load_reports.values():
            report.masters = {}

        self.disc = self.d_state = self.latent_store = None
        if args.gan_loss:
            # the reference strips a 'gan' prefix (gan_sd_model.py:9-13)
            d_arch = (args.gan_model_arch or "sd_1_5").replace("gan", "")
            cross_arch = d_arch.startswith("sdxl") != self.pcfg.is_sdxl
            if cross_arch and not d_arch.startswith("sd_1_5"):
                raise ValueError("--gan_model_arch sdxl with an SD1.5 generator is not "
                                 "supported (the reference never runs it either)")
            gan_cfg = GanConfig(lora_rank=args.lora_rank,
                                lastlayer_cls=args.gan_unet_lastlayer_cls,
                                condition_discriminator=args.condition_discriminator,
                                cross_arch=cross_arch)
            if cross_arch:
                # the published SDXL recipe's SD1.5-architecture D over SDXL
                # latents (64x64x4 in both): a tower of its own, seeded as
                # in JAX (the reference loads the SD1.5 snapshot for it),
                # conditioned on CLIP-L's 768-wide states
                self.logger.warning("the SD1.5-architecture discriminator's UNet is "
                                    "seeded, as in JAX (the reference loads SD1.5)")
                d_unet = (UNetConfig.tiny(cross_attention_dim=self.pcfg.text.hidden_size)
                          if tiny else UNetConfig.sd15())
                self.disc = Discriminator(d_unet, gan_cfg, self.device, seed=seed + 2)
            else:
                # D's frozen base is the generator's own UNet (gan_sd_model.py:8-13),
                # a frozen copy of it when the generator's base trains
                self.disc = Discriminator(self.pcfg.unet, gan_cfg, self.device,
                                          base_unet=self.pipeline.unet, seed=seed + 2,
                                          copy_base=args.full_finetuning)
            self.d_state = init_disc_state(
                self.disc, self.tcfg, lr=args.learning_rate_D, b1=args.adam_beta1_D,
                b2=args.adam_beta2_D, max_grad_norm=args.max_grad_norm_D)
            if args.gan_gt_path:
                self.latent_store = self._latent_store(args.gan_gt_path)

        prompts = load_prompts(args.training_prompts, args.max_train_samples)
        # split by data index: the ranks of one model group see the same rows
        self.dataset = PromptDataset(
            prompts, args.train_batch_size, seed=seed,
            process_index=self.mesh.data_index if self.mesh is not None else 0,
            process_count=self.data_groups)
        # every rank draws the global batch's draws from the same seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if self.mesh is not None:
            mesh_lib.replicate(self._state_tensors(), self.mesh)
            with torch.no_grad():
                for st in (self.state, self.d_state):
                    for n, p in (st.trainable.items() if st is not None else ()):
                        if st.optimizer.masters[n] is not p:
                            p.copy_(st.optimizer.masters[n])

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
                # each rank's store drew for its own prompts: it takes its own
                # state back where the checkpoint holds every rank's
                rngs = extra.get("latent_store_rngs")
                if self.latent_store is not None and rngs is not None:
                    world = self.mesh.world if self.mesh is not None else 1
                    if len(rngs) != world:
                        raise ValueError(f"{path}: latent-store states of {len(rngs)} "
                                         f"ranks, this run has {world}")
                    self.latent_store.rng.setstate(rngs[self.rank])
                elif self.latent_store is not None and "latent_store_rng" in extra:
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
            self.d_state.optimizer if self.d_state is not None else None, self.mesh)
        # an image-dependent segmenter (Grounded-SAM) needs the generated
        # image: each step is split into the presample, the segmentation and
        # the differentiable step replaying the presample's tables
        self.presample = None
        if self.seg_holder is not None and self.seg_holder.image_dependent:
            self.presample = make_presample(self.pipeline, self.tcfg)

        self.metrics = MetricsWriter(
            args.output_dir,
            args.logging_dir if args.report_to in ("tensorboard", "all") else None,
            main=self.rank == 0)
        self._pending_metrics = None
        self._profiler = None
        self._profiled: List[PhaseClock] = []   # the profiled steps' clocks
        self._step_times = []
        # (step, seconds) of each validation, its images fetched included
        self.validation_times = []
        self._stop_requested = False

    def _resolve_pretrained(self, tiny: bool) -> Optional[str]:
        """--pretrain_model resolved (through --cache_dir for a repo id) to
        a snapshot folder, whose file sets are chosen now: a component
        folder without safetensors, or with several variants and no
        non-variant set, raises before any weights are made. Without a
        snapshot the towers keep their seeded weights: a real run refuses
        that unless --allow_smoke; --tiny_models warns, as JAX does."""
        path = resolve_snapshot(self.args.pretrain_model, self.args.cache_dir)
        if not (path and os.path.isdir(path)):
            why = (f"pretrained weights unavailable at {path!r}: the towers would keep "
                   "seeded weights. Pass --pretrain_model a snapshot folder or populate "
                   "--cache_dir")
            if tiny:
                self.logger.warning(why)
            else:
                self._smoke_gate(why, kind="weights")
            return None
        for tower, sub in SNAPSHOT_TOWERS:
            d = os.path.join(path, sub)
            if (tower != "text2" or self.pcfg.is_sdxl) and os.path.isdir(d):
                safetensors_files(d)
        return path

    def _resolve_caption_weights(self, tiny: bool) -> Optional[str]:
        """The caption model's snapshot: --caption_model_path, else the
        reference's default id (load_captionmodel.py:3-8), either resolved
        through --cache_dir (JAX's `_resolve_caption_weights`).
        --tiny_models reads only an explicitly named snapshot; a real run
        without one refuses the seeded captioner unless --allow_smoke."""
        named = self.args.caption_model_path
        if tiny and not named:
            return None
        path = resolve_snapshot(named or CAPTION_MODEL_ID, self.args.cache_dir)
        if path and os.path.isdir(path):
            safetensors_files(path)
            return path
        why = (f"caption-model weights unavailable (looked at {path!r}): the "
               "concept-matching reward would score with a random-weight BLIP. Pass "
               "--caption_model_path or populate --cache_dir")
        if tiny:
            self.logger.warning(why)
        else:
            self._smoke_gate(why, kind="weights")
        return None

    def _record_load(self, what: str, path: str, report: LoadReport) -> LoadReport:
        self.load_reports[what] = report
        gb = report.nbytes / 1e9
        secs = report.read_s + report.copy_s
        self.logger.info("loaded %s from %s: %.3f GB, read %.3f s, copy to %s %.3f s "
                         "(%.2f GB/s)", what, path, gb, report.read_s, self.device,
                         report.copy_s, gb / secs if secs else 0.0)
        if report.unused:
            self.logger.warning("%s: %d unused tensors in %s (first: %s)", what,
                                len(report.unused), path, report.unused[:3])
        return report

    def _gate_missing(self, what: str, path: str, missing: List[str]) -> None:
        """Tensors a snapshot lacks keep their seeded values: refused unless
        --allow_smoke, at --tiny_models too."""
        if missing:
            self._smoke_gate(f"{what} {path} lacks {len(missing)} tensors (first: "
                             f"{missing[:5]}): they would keep seeded weights",
                             kind="weights")

    def _load_pretrained(self, args) -> Dict[str, torch.Tensor]:
        """The snapshot into the pipeline's towers, then --sdxl_unet_path's
        UNet over it (reference training_utils/pipeline.py:28). Returns
        the fp32 masters of the towers --tune_vae, --tune_text_encoder and
        --full_finetuning train. The swapped-in UNet's missing and unused
        names are logged, as JAX logs its unmapped names; the towers'
        missing tensors, the swap's aside, go through the smoke gate."""
        keep = [t for t, on in (("vae", args.tune_vae), ("text", args.tune_text_encoder),
                                ("text2", args.tune_text_encoder),
                                ("unet", args.full_finetuning)) if on]
        reports = {}
        if self.snapshot:
            reports = load_sd_state(self.snapshot, self.pipeline, keep_masters=keep)
            for tower, report in reports.items():
                self._record_load(tower, self.snapshot, report)
        masters = {n: m for r in reports.values() for n, m in r.masters.items()}
        if args.sdxl_unet_path:
            swap = self._record_load("sdxl_unet_path", args.sdxl_unet_path,
                                     load_unet_state(args.sdxl_unet_path, self.pipeline.unet,
                                                     keep_masters="unet" in keep))
            masters.update(swap.masters)
            if swap.missing or swap.unused:
                self.logger.warning(
                    "sdxl_unet_path: %d unmapped params (first: %s), %d unused tensors "
                    "(first: %s)", len(swap.missing), swap.missing[:3], len(swap.unused),
                    swap.unused[:3])
            if "unet" in reports:
                kept = set(swap.missing)
                reports["unet"].missing = [n for n in reports["unet"].missing if n in kept]
        missing = [f"{tower}.{n}" for tower, r in reports.items() for n in r.missing]
        self._gate_missing("snapshot", self.snapshot, missing)
        return masters

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

    def _smoke_gate(self, why: str, kind: str) -> None:
        """Refuse a fidelity-degrading fallback unless --allow_smoke;
        `kind` ("weights", "tokenizer", "data") files it in
        `smoke_fallbacks` when allowed."""
        if self.args.allow_smoke:
            self.logger.warning("SMOKE MODE: %s", why)
            self.smoke_fallbacks.append((kind, why))
            return
        raise RuntimeError(f"refusing to continue: {why}. Pass --allow_smoke to run "
                           "anyway (smoke testing only).")

    def _state_tensors(self) -> List[torch.Tensor]:
        """The fp32 masters of G and D, which `replicate` makes equal on
        every rank at start (the optimizers' moments are empty until the
        first step, and a resume restores the same on every rank)."""
        return [m for st in (self.state, self.d_state) if st is not None
                for m in st.optimizer.masters.values()]

    # ---- loop ----
    def _batch(self, prompts):
        batch = assemble_batch(prompts, self.clip_tok, self.caption_tok,
                               max_length=self.pcfg.text.max_length,
                               latent_store=self.latent_store,
                               clip_tokenizer2=self.clip_tok2)
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

    def _graceful(self, signum, frame) -> None:
        self.logger.warning("signal %d: checkpointing at step %d then exiting",
                            signum, self.global_step)
        self._stop_requested = True

    def train(self) -> None:
        """The loop. SIGTERM/SIGINT during it: checkpoint, then exit (the
        reference has none); the handlers it replaces come back when it
        returns, so that they hold no trainer afterwards."""
        previous = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                previous[sig] = signal.signal(sig, self._graceful)
        except ValueError:
            pass    # not the main thread
        try:
            self._train()
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)

    def train_one(self, prompts) -> Dict[str, float]:
        """One step of the loop on `prompts` (a split step where the
        segmenter needs the image): the batch, its draws, the step, the
        launch counts and the metrics, logged one step late. Returns the
        step's metrics, with `h_step`, the host seconds of the whole call
        (its span "step"), beside `train_step`'s. The step's clock is
        active throughout (`comat_tpu_torch.trace`): its spans are "step",
        "batch", "draws", "presample", "segment", "train_step" and
        "finish", with the layers' own inside them."""
        args = self.args
        if args.batch_repeat > 1:
            prompts = list(prompts) * args.batch_repeat
        clock = PhaseClock(self.device, probe=self.probe)
        with clock.active(), clock.span("step"):
            with clock.span("batch"):
                batch = self._batch(prompts)
            draws = None
            if self.presample is not None:
                # the split step (JAX trainer.py:785-798): the step's
                # draws, taken from the generator as the step takes them (the
                # global batch's under a mesh; the presample takes its rows)
                with clock.span("draws"):
                    draws = sample_draws(self.tcfg, len(prompts) * self.data_groups,
                                         self.pcfg.latent_size, self.generator,
                                         self.device)
                mine = draws if self.mesh is None else local_draws(draws, self.mesh)
                image, eps_table, traj = self.presample(batch, mine, clock)
                with clock.span("segment"):
                    batch["seg_masks"] = self._segment(image)
                batch["eps_table"], batch["latents_traj"] = eps_table, traj
            # the step closes the clock: it has synchronised when it returns
            self.state, m = self.train_step(self.state, batch, draws=draws,
                                            generator=self.generator, clock=clock)
            with clock.span("finish"):
                if self.mesh is not None:
                    # a signal may reach the ranks at different steps: all stop
                    # after the same one, or one would wait forever in a collective
                    with clock.sync("stop_flag"):
                        self._stop_requested = mesh_lib.any_rank(
                            self._stop_requested, self.mesh, self.device)
                self.global_step += 1
                if self.probe is not None:
                    self._add_counts(clock)
                self._flush_pending_metrics()
        m["n_syncs"] = float(clock.n_syncs)
        m["h_step"] = clock.host_seconds("step")
        self._profile_step(clock)
        self._pending_metrics = (self.global_step, m, len(prompts))
        return m

    def _segment(self, image: torch.Tensor) -> torch.Tensor:
        """The masks of this rank's presampled images: the first rank of a
        model group segments, the others take its masks, so that replicas
        cannot disagree."""
        mesh = self.mesh
        if mesh is None or mesh.model == 1:
            return self.seg_holder.device_masks(image)
        if mesh.model_index == 0:
            masks = self.seg_holder.device_masks(image)
        else:
            B, H, W, _ = image.shape
            masks = torch.empty((B, self.seg_holder.max_words, H, W), dtype=torch.uint8,
                                device=image.device)
        return mesh_lib.broadcast_model(masks, mesh)

    def _train(self) -> None:
        args = self.args
        steps_per_epoch = max(len(self.dataset), 1)
        num_epochs = max(1, -(-args.max_train_steps // steps_per_epoch))
        self.logger.info("training: %d steps, %d/epoch, %d epochs; the generator "
                         "updates every %d steps", args.max_train_steps, steps_per_epoch,
                         num_epochs, self.state.optimizer.every)
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
                self.train_one(prompts)
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

    def _profile_step(self, clock: PhaseClock) -> None:
        """--profile_dir: a torch.profiler trace of steps 4-7, counted from
        0 (metrics.jsonl's 5-8; the device's activity on a card, the
        host's on the CPU), written with the steps' spans as
        `<profile_dir>/trace.json` (chrome trace) and reduced to
        `<profile_dir>/profile_summary.json` (`training.profile`)."""
        if not self.args.profile_dir:
            return
        if self._profiler is not None:
            self._profiled.append(clock)
        if self.global_step == 4 and self._profiler is None:
            act = torch.profiler.ProfilerActivity
            self._profiler = torch.profiler.profile(
                activities=[act.CUDA if self.device.type == "cuda" else act.CPU])
            self._profiler.start()
        elif self.global_step == 8 and self._profiler is not None:
            self._profiler.stop()
            paths = write_profile(self._profiler, self._profiled, self.args.profile_dir)
            self._profiler, self._profiled = None, []
            self.logger.info("profile written to %s and %s", *paths)

    def _flush_pending_metrics(self) -> None:
        """Log the previous step's metrics (one step late, as JAX logs
        them) and feed the straggler watchdog. `sec_per_step` is the
        step's own wall time, its host span "step" (`h_step`: the batch,
        the step and its logging); JAX's is the time between two logging
        calls, which in the port would be the next step's."""
        if self._pending_metrics is None:
            return
        pstep, pm, pbs = self._pending_metrics
        self._pending_metrics = None
        host_m = dict(pm)
        dt = pm["h_step"]
        # the reference's per-step keys (training_script.py:667-703); lr
        # as JAX logs it, the schedule at the step count after the update
        host_m["train_loss"] = host_m.get("step_loss", 0.0)
        host_m["lr"] = float(self.lr_fn(pstep))
        host_m["sec_per_step"] = dt
        if dt > 0:
            host_m["images_per_sec"] = pbs * self.data_groups / dt
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

    def _latent_store(self, index: str):
        """The native store over an index of .npy files, else the Python
        one (which also reads the reference's .pt files)."""
        other = next((f for files in read_latent_index(index).values() for f in files
                      if not f.endswith(".npy")), None)
        if other is None:
            return NativeLatentStore(index)
        self.logger.info("latent store %s: %s is not a .npy file, so the Python "
                         "GanLatentStore reads it", index, other)
        return GanLatentStore(index)

    def save_and_evaluate(self, save: bool = True) -> None:
        """Checkpoint, LoRA export and validation images (reference
        training_script.py:382-494; save=False is the eval-only mode
        after a resume, :504-509)."""
        args = self.args
        if save:
            extra = {}
            if self.latent_store is not None:
                state = self.latent_store.rng.getstate()
                if self.mesh is not None and self.mesh.world > 1:
                    # each rank's store draws for its own prompts
                    extra["latent_store_rngs"] = mesh_lib.all_gather_objects(state,
                                                                             self.mesh)
                else:
                    extra["latent_store_rng"] = state
            if self.rank == 0:
                path = ckpt_lib.save_checkpoint(
                    args.output_dir, self.global_step, self.state, self.d_state,
                    self.generator, extra, total_limit=args.checkpoints_total_limit)
                # the reference's artifact name, loadable by diffusers'
                # LoraLoaderMixin (training_script.py:397-401)
                ckpt_lib.export_lora_safetensors(
                    os.path.join(path, "pytorch_lora_weights.safetensors"),
                    self.state.optimizer.masters)
                self.logger.info("saved checkpoint %s", path)
        if (self.rank == 0 and (args.validation_prompts or args.validation_prompts_file)
                and args.num_validation_images > 0):
            self._validate()
        if self.mesh is not None:
            # every rank waits for rank 0's files (the reference's
            # wait_for_everyone)
            mesh_lib.barrier(self.mesh)

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
        ids2 = null2 = None
        if self.clip_tok2 is not None:
            ids2 = self.clip_tok2(prompts, max_length=L)["input_ids"]
            null2 = self.clip_tok2([""], max_length=L)["input_ids"]
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
                    eos_positions=enc["eos_positions"][i:i + 1],
                    input_ids2=None if ids2 is None else ids2[i:i + 1],
                    null_ids2=null2, kind=kind, generator=g, unet=unet)
                rows.append(img[0].float().cpu().numpy())
            self.metrics.log_images(f"validation_{r}", np.stack(rows), self.global_step)
        dt = time.perf_counter() - t0
        self.validation_times.append((self.global_step, dt))
        self.logger.info("validation at step %d: %d prompts x %d rounds, %.3f s",
                         self.global_step, len(prompts), args.num_validation_images, dt)
