"""The trainer driver: one cell runs the port's `Trainer.train_one` on the
launcher's flags, times the window and checks the first steps against the
plain reference.

Set-up (`build`): the inputs (`inputs.py`), the kernels (built once per
checkout), the `Trainer` from `parse_args` over the launcher's argv and
the cell's flags, the benchmark's seeded weights loaded over the
trainer's own (`reference.weights`), then the first `check_steps` steps
through `train_one`, which are both the warm-up and the steps the
reference follows (`_FirstSteps` keeps what they leave). The window
(`window`): steps until `--seconds` have passed, each timed from outside
around the whole `train_one` and a synchronise. Then the trainer is freed
and the reference runs the checked steps again in float32 (`compare`).

`numbers` works out every number the check can compare; the cell's
`limits` name the ones it compares, each with its limit (PERF.md says
which and why). A run is correct when each is within its limit and no
step of the window gave a non-finite loss. `host_gap` holds the host
half of the checked steps (ids, captions, GAN latents, Grounded-SAM's
decode) to a plain recomputation (`reference.host`).

The controls, for reading the limits and never part of a cell's run:
"fp8", the reference computed in float8 (`reference.lowp`) put in the
program's place over the checked steps; "pass1_int8", the program's own
W8A8 pass 1.
"""

from __future__ import annotations

import gc
import os
import shutil
import statistics
import tempfile
import time
import types
from typing import Dict, List

import numpy as np

from benchmark import harness, inputs
from benchmark.reference import host as ref_host
from benchmark.reference import lowp
from benchmark.reference import step as ref_step
from benchmark.reference import weights as ref_weights
from benchmark.work import counts

BATCH_KEYS = ("input_ids", "null_ids", "eos_positions", "input_ids2", "null_ids2",
              "caption_ids", "caption_mask", "caption_labels", "token_idx", "token_valid",
              "word_valid", "gt_latents", "seg_masks")


def recipe(args) -> dict:
    """The recipe's numbers, as the parsed flags state them."""
    return dict(
        total_step=args.total_step, K=args.K, cfg_scale=args.cfg_scale,
        resolution=args.resolution, attrcon_train_steps=args.attrcon_train_steps,
        lora_rank=args.lora_rank, reward_weight=args.reward_weights[0],
        gan_loss_weight=args.gan_loss_weight,
        mask_token_loss_weight=args.mask_token_loss_weight,
        mask_pixel_loss_weight=args.mask_pixel_loss_weight,
        learning_rate=args.learning_rate, adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2, adam_epsilon=args.adam_epsilon,
        adam_weight_decay=args.adam_weight_decay, max_grad_norm=args.max_grad_norm,
        learning_rate_D=args.learning_rate_D, adam_beta1_D=args.adam_beta1_D,
        adam_beta2_D=args.adam_beta2_D, max_grad_norm_D=args.max_grad_norm_D,
        batch=args.train_batch_size)


def _port_names(tower: str, tensors, hf_import):
    if tower in ("unet", "d_unet"):
        return hf_import.unet_from_diffusers(tensors)
    if tower == "vae":
        return hf_import.vae_from_diffusers(tensors)
    if tower in ("text", "text2"):
        return hf_import.clip_from_hf(tensors)
    return hf_import.blip_from_hf(tensors)


def load_weights(trainer, w) -> None:
    """The benchmark's tensors into the trainer's towers, in place. Every
    tensor must land; the trainer may hold only the VAE's encoder besides."""
    from comat_tpu_torch.models import hf_import

    targets = {"unet": trainer.pipeline.unet, "vae": trainer.pipeline.vae,
               "text": trainer.pipeline.text, "blip": trainer.blip}
    if "text2" in w:
        targets["text2"] = trainer.pipeline.text2
    for tower, module in targets.items():
        rep = hf_import.load_into(module, _port_names(tower, dict(w[tower]), hf_import))
        missing = [n for n in rep.missing if not n.startswith(("encoder.", "quant_conv."))]
        if rep.unused or missing:
            raise RuntimeError(f"{tower}: {len(rep.unused)} tensors unused (first "
                               f"{rep.unused[:3]}), {len(missing)} missing (first {missing[:3]})")
    d = {f"unet.{n}": t for n, t in w["d_lora"].items()}
    d.update({f"head.{n}": t for n, t in w["d_head"].items()})
    if "d_unet" in w:
        d.update({f"unet.{n}": t for n, t in
                  hf_import.unet_from_diffusers(dict(w["d_unet"])).items()})
    rep = hf_import.load_into(trainer.disc, d, lora=True)
    if rep.unused or rep.missing:
        raise RuntimeError(f"D: unused {rep.unused[:3]}, missing {rep.missing[:3]}")


def check_config(trainer, cfg) -> None:
    """The trainer runs the configuration's sizes."""
    p, u = trainer.pcfg, cfg["unet"]
    got = dict(block_out_channels=list(p.unet.block_out_channels),
               transformer_layers_per_block=list(p.unet.transformer_layers_per_block),
               attention_heads=list(p.unet.num_attention_heads),
               cross_attention_dim=p.unet.cross_attention_dim,
               text_hidden=p.text.hidden_size, text_layers=p.text.num_layers,
               vae=list(p.vae.block_out_channels), vae_scaling=p.vae.scaling_factor,
               blip=trainer.blip_cfg.vision_hidden_size,
               capture_layers=list(p.capture_layers))
    want = dict(block_out_channels=u["block_out_channels"],
                transformer_layers_per_block=u["transformer_layers_per_block"],
                attention_heads=u["attention_heads"],
                cross_attention_dim=u["cross_attention_dim"],
                text_hidden=cfg["text"]["hidden_size"],
                text_layers=cfg["text"]["num_hidden_layers"],
                vae=cfg["vae"]["block_out_channels"],
                vae_scaling=cfg["vae"]["scaling_factor"],
                blip=cfg["blip"]["vision_hidden_size"],
                capture_layers=cfg["pipeline"]["capture_layers"])
    if got != want:
        raise RuntimeError(f"the trainer's sizes {got} are not the configuration's {want}")


def _np(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return None if x is None else np.array(x, copy=True)


def _sides(g: dict, d: dict) -> dict:
    """G's and D's tensors in one dict: their LoRA factors share names, so
    each is keyed "g.<name>" or "d.<name>"."""
    return {**{"g." + n: v for n, v in g.items()}, **{"d." + n: v for n, v in d.items()}}


def _norms(named) -> Dict[str, float]:
    return {n: float(t.detach().float().norm()) for n, t in named.items()}


def worst_gap(prog: Dict[str, float], ref: Dict[str, float], leaves=None):
    """(The worst leaf's |prog - ref| / max(ref, the median leaf's ref),
    that leaf), the median taken over the leaves whose reference is not
    zero (a LoRA factor facing a zero one has no first gradient)."""
    leaves = sorted(ref) if leaves is None else leaves
    if set(prog) != set(ref):
        raise RuntimeError(f"leaf names differ: {sorted(set(prog) ^ set(ref))[:4]}")
    med = statistics.median([v for v in ref.values() if v > 0] or [0.0])
    worst, where = 0.0, None
    for n in leaves:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if not np.isfinite(gap):
            gap = float("inf")
        if gap >= worst:
            worst, where = gap, n
    return worst, where


class _FirstSteps:
    """What the trainer's first `n` steps leave for the comparison, taken
    where the trainer makes it: each step's prompts and host batch
    (`_batch`), Grounded-SAM's raw device outputs (`forwards`) and decoded
    masks (`_segment`), the final latents the G loss reads (D's first call
    of each step; its second is D's update), D's gradient norm before the
    clip, each step's metrics, the first clipped gradients and, after the
    n steps, each trained tensor's change and the RMS of each G leaf's
    second moment."""

    def __init__(self, trainer, n: int, theta0):
        self.n, self.theta0 = n, theta0
        self.prompts: List[list] = []
        self.batches: List[dict] = []
        self.seg: List[tuple] = []
        self.masks: List[np.ndarray] = []
        self.latents: List[np.ndarray] = []
        self.d_norms: List[float] = []
        self.metrics: List[dict] = []
        self.grads: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        self.v_rms: Dict[str, float] = {}
        self._d_calls = 0
        self._wrap(trainer, "_batch", self._batch)
        if trainer.presample is not None:
            self._wrap(trainer, "_segment",
                       lambda out, *a: self._keep(self.masks, lambda: _np(out)))
        seg = getattr(trainer.seg_holder, "segmenter", None)
        if hasattr(seg, "forwards"):
            self._wrap(seg, "forwards", self._forwards)
        self._wrap(trainer.d_state.optimizer, "step",
                   lambda out, *a, **kw: self._keep(self.d_norms, lambda: float(out)))
        self._wrap(trainer.disc, "logits", self._logits)

    def _keep(self, into: list, value) -> None:
        """Append `value()` while the first steps last: the window pays
        for no copy."""
        if len(into) < self.n:
            into.append(value())

    def _wrap(self, owner, attr: str, seen) -> None:
        inner = getattr(owner, attr)

        def wrapped(*a, **kw):
            out = inner(*a, **kw)
            seen(out, *a, **kw)
            return out

        setattr(owner, attr, wrapped)

    def _batch(self, out, prompts):
        if len(self.batches) < self.n:
            self.prompts.append(list(prompts))
        self._keep(self.batches, lambda: {k: _np(out.get(k)) for k in BATCH_KEYS})

    def _forwards(self, out, images01, rows):
        """Grounded-SAM's detectors' outputs as the host decode reads them
        (float32), with the nouns of each row and the image's size."""
        (boxes, logits), (outs, protos) = out
        self._keep(self.seg, lambda: (
            [list(r[0]) for r in rows], _np(boxes.float()), _np(logits.float()),
            [{k: _np(v.float()) for k, v in o.items()} for o in outs], _np(protos.float()),
            int(images01.shape[1]), int(images01.shape[2])))

    def host(self) -> List[dict]:
        """Per checked step what `reference.host.host_gap` reads."""
        return [{"prompts": p, "batch": b,
                 "seg": self.seg[k] if k < len(self.seg) else None,
                 "masks": self.masks[k] if k < len(self.masks) else None}
                for k, (p, b) in enumerate(zip(self.prompts, self.batches))]

    def _logits(self, out, lat, *a, **kw):
        if self._d_calls % 2 == 0:
            self._keep(self.latents, lambda: lat.detach().float().cpu().numpy().copy())
        self._d_calls += 1

    def step(self, trainer, prompts) -> None:
        """One of the first steps, through the window's own call."""
        self.metrics.append(trainer.train_one(prompts))
        if len(self.metrics) == 1:
            grads = {}
            for side, st in (("g.", trainer.state), ("d.", trainer.d_state)):
                opt = st.optimizer
                b1 = opt.adam.param_groups[0]["betas"][0]
                for n, master in opt.masters.items():
                    grads[side + n] = opt.adam.state[master]["exp_avg"] / (1.0 - b1)
            self.grads = _norms(grads)
        if len(self.metrics) == self.n:
            trained = _sides(trainer.state.trainable, trainer.d_state.trainable)
            self.change = {n: float((p.detach().float() - self.theta0[n].float()).norm())
                           for n, p in trained.items()}
            self.theta0 = None
            opt = trainer.state.optimizer
            self.v_rms = {"g." + n: float(opt.adam.state[m]["exp_avg_sq"].mean().sqrt())
                          for n, m in opt.masters.items()}


def _prompts(trainer):
    epoch = 0
    while True:
        for p in trainer.dataset.epoch(epoch):
            yield p
        epoch += 1


def plant_fault(trainer, fault: str) -> None:
    """Break the timed path underneath (for the checks' own tests and
    readings): "frozen", a step that leaves every trained tensor as it
    was; "half_batch", a step on the first half of the batch only, its
    losses the mean over that half; "token", the first prompt's first
    token id altered where the host batch is made."""
    import torch

    if fault == "token":
        make = trainer._batch

        def altered(prompts):
            batch = make(prompts)
            batch["input_ids"][0, 1] = (int(batch["input_ids"][0, 1]) + 1) % 256
            return batch

        trainer._batch = altered
        return
    inner = trainer.train_step

    def frozen(state, batch, **kw):
        keep = [(p, p.detach().clone()) for st in (trainer.state, trainer.d_state)
                for p in st.trainable.values()]
        state, m = inner(state, batch, **kw)
        with torch.no_grad():
            for p, v in keep:
                p.copy_(v)
        return state, m

    def half(state, batch, draws=None, **kw):
        n = len(batch["input_ids"]) // 2
        batch = {k: (v[:n] if hasattr(v, "shape") and len(v.shape) and v.shape[0] == 2 * n
                     else v) for k, v in batch.items()}
        if "latents_traj" in batch:
            batch["latents_traj"] = batch["latents_traj"][:, :n]
            batch["eps_table"] = batch["eps_table"][:, :n]
        if draws is not None:
            draws = draws._replace(latents0=draws.latents0[:n],
                                   step_noise=draws.step_noise[:, :n])
        elif kw.get("generator") is not None:
            from comat_tpu_torch.training.train_step import sample_draws

            full = sample_draws(trainer.tcfg, 2 * n, trainer.pcfg.latent_size,
                                kw["generator"], trainer.device)
            draws = full._replace(latents0=full.latents0[:n],
                                  step_noise=full.step_noise[:, :n])
        return inner(state, batch, draws=draws, **kw)

    trainer.train_step = {"frozen": frozen, "half_batch": half}[fault]


def build(ctx, work: str):
    """The inputs, the kernels, the trainer on the launcher's flags with the
    benchmark's weights in it. Returns (trainer, the configuration with
    the recipe under "train", the trained tensors' starting values, the
    set-up's marks)."""
    import torch

    from comat_tpu_torch.training.arguments import launcher_argv, parse_args
    from comat_tpu_torch.training.trainer import Trainer

    wl, seed, dev = ctx.wl, ctx.seed, ctx.device
    cfg = dict(wl["cfg"])
    corpus = os.path.join(harness.ROOT, wl["corpus"])
    prompts = inputs.read_lines(corpus)
    tok = inputs.write_byte_vocab(os.path.join(work, "tokenizer"), prompts,
                                  wl["vocab_merges"], cfg["text"]["vocab_size"])
    store = inputs.write_latent_store(os.path.join(work, "store"), prompts, seed,
                                      wl["resolution"] // 8, wl["latent_files"])
    argv = launcher_argv(os.path.join(harness.ROOT, wl["launcher"])) + list(wl["flags"])
    argv += ["--training_prompts", corpus, "--seed", str(seed),
             "--output_dir", os.path.join(work, "output"), "--gan_gt_path", store,
             "--tokenizer_dir", tok, "--report_to", "none", "--allow_smoke"]
    if ctx.control == "pass1_int8":
        argv.append("--pass1_int8")
    args = parse_args(argv)
    marks = [("imports and inputs", time.perf_counter())]
    if dev.type == "cuda":
        from comat_tpu_torch.ops import _build

        _build.build(wl["kernels"] + (["quant_s8", "conv_s8"] if ctx.control == "pass1_int8"
                                      else []))
    marks.append(("kernels", time.perf_counter()))
    trainer = Trainer(args)
    marks.append(("trainer", time.perf_counter()))
    check_config(trainer, cfg)
    cfg["train"] = recipe(args)
    w = ref_weights.make(cfg, seed, dev)
    load_weights(trainer, w)
    theta0 = {**{f"g.unet.{n}": t for n, t in w["unet"].items()
                 if n.endswith(("lora_a", "lora_b"))},
              **{f"d.unet.{n}": t for n, t in w["d_lora"].items()},
              **{f"d.head.{n}": t for n, t in w["d_head"].items()}}
    _sync(torch, dev)
    marks.append(("weights", time.perf_counter()))
    cfg["host"] = dict(tokenizer=tok, store=store)
    return trainer, cfg, theta0, marks


def window(ctx, trainer, feed, spans):
    """Steps until --seconds have passed (and the traced steps are done),
    each timed from outside around `train_one` and a synchronise; with
    --trace the first `trace_steps` under the profiler (the device's
    activity) beside the host spans. Returns (metrics of each step, wall
    seconds of each, the window's seconds, the profiler or None)."""
    import torch

    dev = ctx.device
    trace_steps = ctx.wl["trace_steps"] if ctx.trace else 0
    prof, steps, walls = None, [], []
    t_start = time.perf_counter()
    while True:
        if len(steps) < trace_steps and prof is None:
            # the device's activity only: recording every host op as well
            # made an SD1.5 step 2.6 times as long
            act = torch.profiler.ProfilerActivity
            prof = torch.profiler.profile(activities=[act.CUDA if dev.type == "cuda"
                                                      else act.CPU])
            prof.start()
            spans.on = True
        t0 = time.perf_counter()
        with spans.span("step"):
            steps.append(trainer.train_one(next(feed)))
            _sync(torch, dev)
        walls.append(time.perf_counter() - t0)
        if prof is not None and len(steps) == trace_steps:
            prof.stop()
            spans.on = False
        if time.perf_counter() - t_start >= ctx.seconds and len(steps) >= trace_steps:
            return steps, walls, time.perf_counter() - t_start, prof


def run(ctx) -> harness.Result:
    import torch

    wl, dev = ctx.wl, ctx.device
    work = tempfile.mkdtemp(prefix="comat-bench-")
    try:
        trainer, cfg, theta0, marks = build(ctx, work)
        B = cfg["train"]["batch"]
        if ctx.fault:
            plant_fault(trainer, ctx.fault)
        first = _FirstSteps(trainer, wl["check_steps"], theta0)
        del theta0
        spans = harness.HostRanges()
        if ctx.trace:
            for owner, attr in ((trainer, "_batch"), (trainer, "presample"),
                                (trainer.seg_holder, "device_masks"), (trainer, "train_step")):
                spans.wrap(owner, attr, attr if owner is trainer else "seg_holder." + attr)
        feed = _prompts(trainer)
        for k in range(wl["check_steps"]):
            first.step(trainer, next(feed))
            marks.append((f"step {k + 1}", time.perf_counter()))
        _sync(torch, dev)
        setup_s = time.perf_counter() - ctx.t0
        parts, last = [], ctx.t0
        for name, t in marks:
            parts.append(f"{name} {t - last:.3f}")
            last = t
        harness.log(f"setup: {setup_s:.3f} s ({', '.join(parts)} s)")

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        sampler = harness.ClockSampler(dev.index or 0) if dev.type == "cuda" else None
        steps, walls, elapsed, prof = window(ctx, trainer, feed, spans)
        device = harness.device_info(torch, dev, 1)
        harness.say(sampler.stop() if sampler is not None else "clocks: not a card")
        n = len(steps)
        images_per_s = n * B / elapsed
        failed = sum(1 for m in steps if not np.isfinite(m["step_loss"]))
        harness.say(f"window: {n} steps of {B} images in {elapsed!r} s; step walls {walls}")
        result_breakdown = None
        if ctx.trace:
            summary = harness.summarise_profile(prof, spans)
            traced = wl["trace_steps"]
            rest = walls[traced:]
            harness.say(f"profile: device clock shifted {summary.offset_ns} ns onto the host's")
            harness.say(f"traced run: images_per_s {images_per_s!r} over the window, "
                        f"{traced * B / sum(walls[:traced])!r} over its {traced} profiled "
                        f"steps, {(len(rest) * B / sum(rest)) if rest else None!r} over the "
                        f"{len(rest)} others")
            device["busy_s"], device["window_s"] = summary.busy_s, summary.window_s
            trace = types.SimpleNamespace(
                steps=steps, walls=walls, profile=summary, cfg=cfg, wl=wl, batch=B,
                step_flops=counts.train_step_flops(cfg, cfg["train"], B),
                flash_calls=counts.flash_calls(cfg, cfg["train"], B))
            metrics = harness.read_metrics(
                harness.per_layer_metrics(ctx.spec, ctx.workload), trace)
            result_breakdown = harness.breakdown(summary)
        else:
            metrics = {
                "setup_s": {"value": setup_s, "unit": "s"},
                "images_per_s": {"value": images_per_s, "unit": "images/s"},
                "peak_mem_gib": {"value": device["memory_peak_bytes"] / 2 ** 30,
                                 "unit": "GiB"}}

        # the reference, once the trainer and its memory are freed
        del trainer, feed, steps, prof
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        checks = compare(cfg, ctx.seed, dev, first, wl["limits"], ctx.control)
        harness.log(f"reference: {time.perf_counter() - t_ref:.3f} s for "
                    f"{wl['check_steps']} steps")
        correct = all(c["value"] <= c["limit"] for c in checks.values()) and failed == 0
        return harness.Result(correct=correct, attempted=n, failed=failed, metrics=metrics,
                              device=device, checks=checks, breakdown=result_breakdown)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


TERMS = ("step_loss", "D_loss", "G_loss", "reward_blip", "token_loss", "pixel_loss")


def _rel(a: float, b: float) -> float:
    """|a - b| against |b|, or 1e-3 where a loss term is smaller: a term
    at zero to rounding (a grounding loss whose attention already lies in
    its masks) read 0 against 5.2e-16, a gap of 1 that says nothing."""
    gap = abs(a - b) / max(abs(b), 1e-3)
    return gap if np.isfinite(gap) else float("inf")


def numbers(first: _FirstSteps, ref_steps, change, theta_names) -> Dict[str, tuple]:
    """Every number the check can compare, as (value, where): per step
    `loss_gap.step<k>`, the worst relative gap of the step's loss terms;
    per group of trained leaves (G, D's LoRA factors, D's head) the first
    clipped gradient's and the change's worst leaf (`worst_gap`), the
    change over the leaves whose reference gradient reaches a thousandth
    of the group's median leaf in some checked step."""
    out = {}
    for k, (pm, rs) in enumerate(zip(first.metrics, ref_steps), start=1):
        gaps = {t: _rel(pm[t], rs[t]) for t in TERMS if t in pm}
        worst = max(gaps, key=gaps.get)
        out[f"loss_gap.step{k}"] = (gaps[worst], worst)
        lat, want = first.latents[k - 1], rs["latents"]
        gap = (float(np.linalg.norm(lat - want) / np.linalg.norm(want))
               if lat.shape == want.shape else float("inf"))
        out[f"latents_gap.step{k}"] = (gap, "final latents")
    groups = {"G": [n for n in theta_names if n.startswith("g.")],
              "D_lora": [n for n in theta_names if n.startswith("d.unet.")],
              "D_head": [n for n in theta_names if n.startswith("d.head.")]}
    ref_first = _norms(_sides(ref_steps[0]["g_grads"], ref_steps[0]["d_grads"]))
    for tag, names in groups.items():
        out[f"grad_gap.{tag}"] = worst_gap({n: first.grads[n] for n in names},
                                           {n: ref_first[n] for n in names})
        moved = set()
        for rs in ref_steps:
            every = _sides(rs["g_grads"], rs["d_grads"])
            g = _norms({n: every[n] for n in names})
            med = statistics.median([v for v in g.values() if v > 0] or [0.0])
            moved |= {n for n, v in g.items() if v >= 1e-3 * med}
        gap, leaf = worst_gap({n: first.change[n] for n in names},
                              {n: change[n] for n in names}, leaves=sorted(moved))
        out[f"change_gap.{tag}"] = (gap, f"{leaf} ({len(moved)} of {len(names)} leaves)")
    return out


def reference_steps(cfg, seed, dev, first: _FirstSteps, fp8: bool = False):
    """The reference over the checked steps on the program's host batches
    and masks, in float32 with TF32 off (`fp8`: every GEMM's operands in
    float8). Returns (each step's readings, each trained tensor's change,
    the trained tensors' names, the RMS of each G leaf's second moment)."""
    import torch

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        w = ref_weights.make(cfg, seed, dev)
        ref = ref_step.ReferenceTrainer(cfg, w, dev)
        del w
        if fp8:
            towers = (ref.unet, ref.vae, ref.text, ref.text2, ref.blip, ref.d_unet)
            for tower in {id(t): t for t in towers if t is not None}.values():
                lowp.lower(tower)
        theta0 = {n: t.detach().clone() for n, t in _sides(ref.g, ref.d).items()}
        gen = torch.Generator(device=dev).manual_seed(seed)
        tc = cfg["train"]
        ref_steps = []
        for k, batch in enumerate(first.batches):
            draws = ref_step.step_draws(tc, tc["batch"], tc["resolution"] // 8, gen)
            ref_steps.append(ref.step(batch, first.masks[k] if first.masks
                                      else batch["seg_masks"], draws))
        change = _norms({n: p.detach() - theta0[n] for n, p in _sides(ref.g, ref.d).items()})
        v_rms = {"g." + n: float(ref.g_opt.adam.state[p]["exp_avg_sq"].mean().sqrt())
                 for n, p in ref.g.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return ref_steps, change, sorted(theta0), v_rms


def put_in_place(first: _FirstSteps, steps, change, v_rms) -> None:
    """The control's readings in the program's place."""
    for k, rs in enumerate(steps):
        first.metrics[k] = {**{t: rs[t] for t in TERMS}, "grad_norm": rs["g_norm"]}
        first.latents[k] = rs["latents"]
        first.d_norms[k] = rs["d_norm"]
    first.grads = _norms(_sides(steps[0]["g_grads"], steps[0]["d_grads"]))
    first.change, first.v_rms = change, v_rms


def compare(cfg, seed, dev, first: _FirstSteps, limits, control=None) -> Dict[str, dict]:
    """Hold the host half to its plain recomputation, run the reference over
    the checked steps and return the numbers that `limits` names, each with
    its limit; log every number."""
    host = cfg["host"]
    gaps = ref_host.host_gap(first.host(), host["tokenizer"], host["store"],
                             cfg["text"]["max_position_embeddings"], cfg["blip"]["vocab_size"])
    set_px = sum(int(np.count_nonzero(m)) for m in first.masks)
    harness.log(f"host: {gaps} entries differ; the program's masks set {set_px} pixels")
    if control == "fp8":
        steps, change, _, v_rms = reference_steps(cfg, seed, dev, first, fp8=True)
        put_in_place(first, steps, change, v_rms)
        del steps
        harness.log("control: the reference in float8 in the program's place")
    ref_steps, change, names, v_rms = reference_steps(cfg, seed, dev, first)
    for k, out in enumerate(ref_steps):
        pm = first.metrics[k]
        harness.log(f"step {k + 1}: " + ", ".join(
            f"{t} {pm[t]!r} / {out[t]!r}" for t in TERMS if t in pm)
            + f", G norm {pm['grad_norm']!r} / {out['g_norm']!r}, D norm "
            f"{first.d_norms[k]!r} / {out['d_norm']!r} (program / reference)")
    found = numbers(first, ref_steps, change, names)
    found["host_gap"] = (sum(gaps.values()), ", ".join(f"{k} {v}" for k, v in gaps.items() if v))
    harness.log("numbers: " + "; ".join(f"{k} {v!r} at {w}" for k, (v, w) in found.items()))
    for name in ("change_gap.D_lora", "change_gap.G"):
        leaf = found[name][1].split(" (")[0]
        if leaf in first.change:
            moment = (f", second moment RMS {first.v_rms[leaf]!r} / {v_rms[leaf]!r}"
                      if leaf in first.v_rms else "")
            harness.log(f"{name} leaf {leaf}: change {first.change[leaf]!r} / "
                        f"{change[leaf]!r}{moment} (program / reference)")
    return {name: {"value": found[name][0], "limit": limit} for name, limit in limits.items()}
