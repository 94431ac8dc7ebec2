#!/usr/bin/env python3
"""Smoke run of the PyTorch port (comat_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure ends the run with a nonzero exit and no result line:
1. build: print the card's name and power limit, build every CUDA kernel
   (one nvcc per source, all four at once), print what ptxas reports for
   each kernel (registers, spills), and count the tensor-core
   instructions (HGMMA, HMMA) of each kernel in the built SASS
   (`cuobjdump -sass`); fail if the bf16 code of the flash forward (A),
   of its dq or dk/dv backward, of the 3x3 conv (B) or of its dw has none;
2. kernels: each kernel against its plain PyTorch version at the shapes
   the two main paths give it, in fp32 (TF32 off) and bf16, with its time,
   the plain version's, one PyTorch library call's, and its bound: the
   flash-attention forward, its dq and dk/dv backward kernels, the 3x3
   conv forward, its dx (the forward kernel through the autograd Function,
   against the plain vjp) and its dw (also at the shapes phase 4 gives
   it, where the train step runs it);
3. generation parity: SD1.5 at full width, fp32, 256^2, 1 prompt, 2 DDPM
   steps, the same seeded weights and injected noise on the card and on
   this machine's CPU; images within 1e-3;
4. train parity: the full CoMat train step's loss and gradients (the BLIP
   reward, the latent GAN with its D update, attribute concentration with
   CenterPrior masks), SD1.5 and BLIP-large at full width, fp32, 256^2,
   1 prompt, total_step 4, K 2, A 2, LoRA 128 with nonzero lora_b in G and
   in D (D's base G's UNet, its head the mlp), the VAE trained too (so dw
   runs), the same weights and draws on the card and the CPU; the loss and
   each component within 1e-3, every LoRA, VAE and D gradient leaf within
   1e-3 relative (a leaf whose CPU gradient is below 1e-6 of the largest,
   zero in exact arithmetic, within 1e-5 of the largest gradient instead);
5. generation main path: `comat_tpu_torch.tools.generate.main` at SD1.5
   full width, 512^2, bf16, 2 prompts, 50 DDPM steps, CFG 7.5, seeded
   weights, the hash tokenizer at vocab 49408; finite (2, 512, 512, 3)
   images and the expected kernel launch counts;
6. train main path: `make_train_step` on the published recipe
   (scripts/sd15.sh): SD1.5 and BLIP-large at full width, bf16 towers and
   fp32 LoRA 128, 512^2, 4 prompts (CFG batch 8), total_step 50, K 5, lr
   5e-5, clip 0.1, 3 steps; finite loss and gradient norm, LoRA leaves
   changed, the expected launch counts, seconds per step and its split;
7. train with the VAE trained (`tune_vae`): the recipe of phase 6 on its
   pipeline, with a fresh `init_train_state(tune_vae=True)`: the bf16
   decoder trains through fp32 masters, so the 21 gated decoder convs
   launch the bf16 dw each step; 2 steps; finite loss and gradient norm,
   every VAE and LoRA master changed (but the encoder's zero biases,
   which no gradient reaches and weight decay keeps at zero), every bf16
   working copy equal to its master rounded, the expected launch counts
   (dw all bf16), seconds per step, its split and peak memory;
8. the full recipe (scripts/sd15.sh with --gan_loss and attribute
   concentration) on phase 6's pipeline and BLIP: D an SD1.5 UNet with
   LoRA 128 and the mlp head sharing G's base, its optimizer sd15.sh's
   (lr 2e-5, b1 0, clip 1), seeded gt_latents, CenterPrior masks, A 2;
   3 steps; every loss component finite, every LoRA, D LoRA and head
   leaf moved, the launch counts of each kernel by role (pass 1, replay,
   capture, decode, D forward, D backward) as expected, seconds per step,
   its split (CUDA events) and peak memory;
9. the trainer CLI: `comat_tpu_torch.train.main` with the flags of
   comat_tpu_torch/scripts/sd15.sh (the repo's scripts/sd15.sh, with
   --gradient_checkpointing and --seg_model gsam, plus --allow_smoke,
   the launcher's own defaults, not the caller's environment): each step
   split into the no-grad presample (pass 1 and the VAE decode), the
   Grounded-SAM segmentation of its 4 images (GroundingDINO-T at 800^2
   and FastSAM-x at 512^2, bf16, seeded weights) and the differentiable
   step replaying pass 1 from the presample's tables; 512^2, batch 4,
   LoRA 128, 4 steps, one validation image at step 0, 3 and 4 and a
   checkpoint at 3 and 4
   (--validation_steps 3, --checkpoints_total_limit 2), against a
   GanLatentStore whose latents the VAE encoder made from seeded images
   (its own counted path); then a run resumed from its checkpoint-3
   (`--resume_from_checkpoint latest` in a directory holding only that
   checkpoint, --max_train_steps 4): the restored tensors equal those
   saved, and its step 4 (the 4th batch inside the first epoch of
   abc5k) ends with the uninterrupted run's checkpoint-4, bit for bit.
   Seconds per step, its split (s_presample, s_segment and its host
   part among them), peak memory, the seconds of each validation and the
   launches by role (the presample's decode a role of its own), each
   beside phase 8's;
10. Grounded-SAM parity: GroundingDINO-T (swint_ogc, 800^2 input) and
   FastSAM-x at full width with seeded weights, fp32, one 512^2 image and
   two nouns, on the card and on the CPU: boxes, token logits, FastSAM's
   heads and protos within 1e-3 of each output's max abs (where the two
   runs' two-stage query selections differ, only at scores tied within
   that tolerance, the card runs again on the CPU's selection); the masks
   the host decode makes from the card's outputs equal the CPU's, or
   differ only where some score lies within the tolerance of its
   threshold (the count of such scores printed). Then
   `GroundedSAMSegmenter.batch` in bf16 at batch 4 (512^2, GroundingDINO
   at 800^2), timed apart: the device forwards and the host decode.
Then one JSON line {"kernels": [...], "checks": [...]} and, last, the
device line. A kernel entry's `launches` counts the launches at its shape
in the driven paths: generation, the reduced recipe's train step, the
same step with the VAE trained, phase 4's fp32 card run of the train step
with the VAE trained (dw), the full recipe's step, the latent store's
encoding and the trainer CLI's run. Weights are random (the real ones are
not in the repository); depth is not cut.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
# |kernel - plain| <= ATOL + RTOL * |plain|, elementwise
TOLS = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 2.0 ** -7)}
# (B, H, Sq, Skv, d): generation (CFG batch 4), train (CFG batch 8, VAE
# batch 4), and a ragged one
GEN_FLASH = [(4, 8, 4096, 4096, 40), (4, 8, 1024, 1024, 80),
             (4, 8, 256, 256, 160), (2, 1, 4096, 4096, 512)]
TRAIN_FLASH = [(8, 8, 4096, 4096, 40), (8, 8, 1024, 1024, 80),
               (8, 8, 256, 256, 160), (4, 1, 4096, 4096, 512)]
RAGGED_FLASH = (1, 8, 1000, 1100, 80)
# validation's generate: one prompt (CFG batch 2, B*H = 16) and its
# decode at batch 1
VAL_FLASH = [(2, 8, 4096, 4096, 40), (2, 8, 1024, 1024, 80), (2, 8, 256, 256, 160),
             (1, 1, 4096, 4096, 512)]
# the flash backward at batch 4 (B*H = 32): the full recipe's D backward
# for the G loss and its capture backward, both at the prompt batch
HALF_BATCH_FLASH = [(4, 8, 4096, 4096, 40), (4, 8, 1024, 1024, 80),
                    (4, 8, 256, 256, 160)]
# (H, C, Cout): the 21 gated convs of the 512^2 decoder, 7 distinct shapes
DECODER_CONVS = [(128, 512, 512), (256, 512, 512), (256, 512, 256),
                 (256, 256, 256), (512, 256, 256), (512, 256, 128),
                 (512, 128, 128)]
# (H, C, Cout): the 14 gated convs of the 256^2 decoder, 6 distinct shapes,
# where phase 4 (batch 1, fp32, the VAE trained) launches dw
PARITY_DW_CONVS = [(128, 512, 512), (128, 512, 256), (128, 256, 256),
                   (256, 256, 256), (256, 256, 128), (256, 128, 128)]
# (H, C, Cout): the 12 gated convs of the 512^2 encoder, the shapes the
# decoder's list lacks (the others: 512/128/128, 256/256/256, 128/512/512)
ENCODER_CONVS = [(256, 128, 256), (128, 256, 512)]
GEN_BATCH, TRAIN_BATCH = 2, 4
# the trainer CLI (phase 9): its launcher, steps and, per step by role,
# phase 8's launches but for remat: the replay's UNet forward inside its
# backward runs each checkpointed transformer block again (+75 A), and
# the decoder runs its 18 gated resnet convs again (+18 B forward); pass 1
# runs the LoRA'd UNet unfused (the same 750 A)
SD15_LAUNCHER = os.path.join("comat_tpu_torch", "scripts", "sd15.sh")
CLI_STEPS, CLI_RESUME = 4, 3
CLI_LAUNCHES = {
    "pass1": {"flash_fwd": 750},
    # the split step's presample decodes its latents, without gradient
    "presample": {"flash_fwd": 1, "conv_fwd": 21},
    "replay": {"flash_fwd": 150, "dq": 75, "dkv": 75},
    "capture": {"flash_fwd": 60, "dq": 30, "dkv": 30},
    "decode": {"flash_fwd": 1, "dq": 1, "dkv": 1, "conv_fwd": 39, "conv_dx": 21},
    "d_forward": {"flash_fwd": 30},
    "d_backward": {"dq": 30, "dkv": 30},
}
# one validation image: 50 CFG UNet calls (15 A each) and its decode
VALIDATION_LAUNCHES = {"flash_fwd": 751, "conv_fwd": 21}
# encoding 4 images at 512^2: the 12 gated encoder convs and the
# mid-block attention
ENCODE_LAUNCHES = {"flash_fwd": 1, "conv_fwd": 12}
TRAIN_PROMPTS = ["a red cube on top of a blue sphere",
                 "a photo of two cats and a green umbrella",
                 "a yellow bus parked next to a brown horse",
                 "three white cups on a wooden table"]
MAIN_FLASH_LAUNCHES = 15 * 50 + 1   # 15 self-attentions over >128 keys x 50 + VAE
MAIN_CONV_LAUNCHES = 21
PARITY_FLASH_LAUNCHES = 10 * 2 + 1  # 256^2: 5 at S=1024 and 5 at S=256, x 2 + VAE
PARITY_CONV_LAUNCHES = 14
TRAIN_STEPS = 3
TUNE_VAE_STEPS = 2
FULL_STEPS = 3
# per step of the full recipe (phase 8), by role (segments of the step's
# PhaseClock): 15 self-attentions over >128 keys a UNet call; the capture
# runs 2 cond-half forwards and recomputes both in its backward; D runs
# once at batch 4 for the G loss (backward into the latents) and once at
# batch 8 for its update (backward into its LoRA)
FULL_ROLES = {
    "pass1": ("pass1", "presample_pass1"),
    "presample": ("presample_decode",),
    "replay": ("replay_fwd", "replay_bwd"),
    "capture": ("capture_fwd", "capture_bwd"),
    "decode": ("decode_fwd", "decode_bwd"),
    "d_forward": ("gan_fwd", "d_fwd"),
    "d_backward": ("gan_bwd", "d_bwd"),
}
FULL_LAUNCHES = {
    "pass1": {"flash_fwd": 750},
    "presample": {},
    "replay": {"flash_fwd": 75, "dq": 75, "dkv": 75},
    "capture": {"flash_fwd": 60, "dq": 30, "dkv": 30},
    "decode": {"flash_fwd": 1, "dq": 1, "dkv": 1, "conv_fwd": 21, "conv_dx": 21},
    "d_forward": {"flash_fwd": 30},
    "d_backward": {"dq": 30, "dkv": 30},
}
# per train step at 512^2: flash forward in pass 1, in the K=5 replay
# recomputes and in the decode; its backward in the replay and the decode;
# the 21 gated decoder convs forward and dx; no dw (the VAE is frozen)
TRAIN_LAUNCHES = {"flash_fwd": 750 + 75 + 1, "dq": 75 + 1, "dkv": 75 + 1,
                  "conv_fwd": 21, "conv_dx": 21, "dw": 0}
# per step of phase 7 (the recipe with the VAE trained): the same, and the
# bf16 dw of each of the 21 gated decoder convs
TUNE_VAE_LAUNCHES = {**TRAIN_LAUNCHES, "dw": 21}
# the train parity run at 256^2, total_step 4, K 2, A 2, VAE trained, GAN
# and attribute concentration on: 10 self-attentions over >128 keys a UNet
# call; forward in pass 1 (4), the replay recomputes (2), the capture
# forwards and their recomputes (2 + 2), D for the G loss and D's update
# (1 + 1), and the decode; backward in the replay, the capture, D twice
# and the decode
PARITY_TRAIN_LAUNCHES = {"flash_fwd": 10 * (4 + 2 + 4 + 2) + 1,
                         "dq": 10 * (2 + 2 + 2) + 1, "dkv": 10 * (2 + 2 + 2) + 1,
                         "conv_fwd": 14, "conv_dx": 14, "dw": 14}
# the capture layers at 256^2, the counterparts of SD1.5's list at 512^2
# (as the JAX package's real-geometry fixture sets them)
PARITY_CAPTURE = ("mid_4", "up_8", "up_16", "up_32")
GRAD_TOL = 1e-3   # relative, per leaf, as tools/step_loss_fixture.py measures it
LOSS_TOL = 1e-3
# A leaf whose CPU gradient stays below ZERO_LEAF_REL of the largest
# gradient of any leaf is zero in exact arithmetic (a key bias adds the
# same q.b to every logit of a query, which the softmax cancels): both
# sides hold rounding noise there, so it is held to an absolute bound,
# ZERO_LEAF_TOL times the largest gradient, instead of a relative one.
ZERO_LEAF_REL = 1e-6
ZERO_LEAF_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# kernel functions whose SASS must hold tensor-core instructions: the
# bf16 code of the flash forward (A), of its dq and dk/dv backward, of the
# 3x3 conv (B) and of its dw
TENSOR_CORE_KERNELS = ("flash_fwd_bf16_kernel", "flash_bwd_dq_bf16_kernel",
                       "flash_bwd_dkv_bf16_kernel", "conv3x3_bf16_kernel",
                       "conv3x3_dw_bf16_kernel")


def sass_tensor_core_counts(lib_path: str) -> dict:
    """{kernel function: (HGMMA count, HMMA count)} in a built library's
    SASS, read with cuobjdump from the toolkit that built it."""
    from comat_tpu_torch.ops._build import _nvcc

    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = [0, 0]
        elif name is not None and "HGMMA" in line:
            counts[name][0] += 1
        elif name is not None and "HMMA" in line:
            counts[name][1] += 1
    return {n: tuple(c) for n, c in counts.items()}


def phase_sass(paths) -> dict:
    """Print each kernel's tensor-core instruction counts; raise unless
    every bf16 instantiation of TENSOR_CORE_KERNELS has some."""
    found = {}
    for source, path in sorted(paths.items()):
        others = [0, 0, 0]
        for fn, (hgmma, hmma) in sass_tensor_core_counts(path).items():
            kernel = next((k for k in TENSOR_CORE_KERNELS if k in fn), None)
            if kernel is None:
                others = [others[0] + 1, others[1] + hgmma, others[2] + hmma]
                continue
            found.setdefault(kernel, []).append(hgmma + hmma)
            log(f"  {source}: {fn}: {hgmma} HGMMA, {hmma} HMMA")
        if others[0]:
            log(f"  {source}: {others[0]} other kernels: {others[1]} HGMMA, "
                f"{others[2]} HMMA")
    for kernel in TENSOR_CORE_KERNELS:
        if not found.get(kernel) or min(found[kernel]) == 0:
            raise AssertionError(f"{kernel}: no tensor-core instructions in "
                                 f"its SASS ({found.get(kernel)})")
    return found


def time_ms(torch, fn, budget_ms: float = 300.0) -> float:
    """Mean ms per call on the card (CUDA events), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(3, min(50, int(budget_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def conv_ops(B: int, Hs: int, C: int, Cout: int, dtype: str) -> float:
    """Operations of a 3x3 SAME conv (forward, dx or dw: the same count).
    bf16 counts the direct sum, 2*B*H*W*9*C*Cout, as tensor cores run it.
    fp32 counts Winograd F(4x4, 3x3), 36 products per 4x4 output tile
    where the direct sum has 144: cuDNN's fp32 dw runs that algorithm on
    this card, in true fp32, and beats the direct count's bound
    (`python -m comat_tpu_torch.tools.probe_conv_library`)."""
    direct = 2.0 * B * Hs * Hs * 9 * C * Cout
    return direct / 4 if dtype == "float32" else direct


def bound_ms(flops: float, nbytes: float, dtype: str):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_close(name, got, want, dtype) -> float:
    atol, rtol = TOLS[dtype]
    got, want = got.detach(), want.detach()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    excess = float((diff - rtol * want.float().abs()).max())
    if not math.isfinite(err) or excess > atol:
        raise AssertionError(
            f"{name}: max |kernel - plain| = {err:.3e} exceeds "
            f"{atol:g} + {rtol:g}*|plain|"
        )
    return err


def _entry(name, source, replaces, kernel, key, shape, dtype, err, times, flops,
           nbytes, library, **extra):
    ms, plain, lib = times
    bms, by = bound_ms(flops, nbytes, dtype)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                shape=list(shape), dtype=dtype, kernel=kernel, key=key,
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib, library=library, **extra)


def _log_entry(e) -> None:
    lib_err = (f", its err {e['library_max_abs_err']:.2e}"
               if "library_max_abs_err" in e else "")
    log(f"  {e['name']} {e['dtype']} {e['shape']}: err {e['max_abs_err']:.2e}, "
        f"{e['ms']:.3f} ms (plain {e['plain_ms']:.3f}, {e['library']} "
        f"{e['library_ms']:.3f}{lib_err}, bound {e['bound_ms']:.3f} by {e['bound_by']})")


def _flash_inputs(torch, gen, shape, dt):
    """q, k, v, dO as (B, S, H, d) head splits of a projection, as on the
    path; dO scaled so that the gradients are of order one."""
    B, H, Sq, Skv, d = shape
    q, k, v, do = (torch.randn(B, S, H, d, generator=gen, device="cuda")
                   .transpose(1, 2) for S in (Sq, Skv, Skv, Sq))
    return q.to(dt), k.to(dt), v.to(dt), (do * math.sqrt(Sq)).to(dt)


def check_flash_fwd(torch, fa, gen, shape, dtype):
    import torch.nn.functional as F

    dt = getattr(torch, dtype)
    B, H, Sq, Skv, d = shape
    q, k, v, _ = _flash_inputs(torch, gen, shape, dt)
    o, lse = fa.flash_attention(q, k, v, want_lse=True)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    err = max(check_close("flash o", o, o_ref, dtype),
              check_close("flash lse", lse, lse_ref, "float32"
                          if dtype == "float32" else dtype))
    del o, lse, o_ref, lse_ref
    times = (time_ms(torch, lambda: fa.flash_attention(q, k, v)),
             time_ms(torch, lambda: fa.flash_attention_ref(q, k, v)),
             time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v)))
    nbytes = (2 * B * H * Sq * d + 2 * B * H * Skv * d) * q.element_size()
    return [_entry("flash_attention_fwd", "comat_tpu_torch/csrc/flash_fwd.cu",
                   "comat_tpu/ops/flash_attention.py:86", "comat_flash_fwd",
                   (B * H, Sq, Skv, d, dtype), [B * H, Sq, Skv, d], dtype, err,
                   times, 4.0 * B * H * Sq * Skv * d, nbytes,
                   "F.scaled_dot_product_attention")]


def check_flash_bwd(torch, fa, gen, shape, dtype):
    """dq, dk, dv against `flash_attention_bwd_ref`. The plain and library
    times are of the whole backward (dq, dk and dv together): the plain
    version and autograd of F.scaled_dot_product_attention compute the
    three at once."""
    import torch.nn.functional as F

    dt = getattr(torch, dtype)
    B, H, Sq, Skv, d = shape
    q, k, v, do = _flash_inputs(torch, gen, shape, dt)
    o, lse = fa.flash_attention(q, k, v, want_lse=True)
    dvec = (do.float() * o.float()).sum(-1)
    got = fa.flash_attention_bwd(q, k, v, do, lse, dvec)
    want = fa.flash_attention_bwd_ref(q, k, v, do, lse, dvec)
    torch.cuda.synchronize()
    errs = [check_close(f"flash {n}", g, w, dtype)
            for n, g, w in zip(("dq", "dk", "dv"), got, want)]
    del got, want
    args = (q, k, v, do, lse, dvec)
    plain = time_ms(torch, lambda: fa.flash_attention_bwd_ref(*args))
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qs, ks, vs)
    lib = time_ms(torch, lambda: torch.autograd.grad(o_lib, (qs, ks, vs), do,
                                                     retain_graph=True))
    del o_lib
    BH, e = B * H, q.element_size()
    in_bytes = (2 * BH * Sq * d + 2 * BH * Skv * d) * e + 2 * BH * Sq * 4
    common = dict(shape=[BH, Sq, Skv, d], dtype=dtype,
                  library="autograd(F.scaled_dot_product_attention)")
    out = [
        _entry("flash_attention_bwd_dq", "comat_tpu_torch/csrc/flash_bwd.cu",
               "comat_tpu/ops/flash_attention.py:136", "comat_flash_bwd_dq",
               (BH, Sq, Skv, d, dtype), err=errs[0],
               times=(time_ms(torch, lambda: fa.flash_attention_bwd_dq(*args)),
                      plain, lib),
               flops=6.0 * BH * Sq * Skv * d, nbytes=in_bytes + BH * Sq * d * e,
               **common),
        _entry("flash_attention_bwd_dkv", "comat_tpu_torch/csrc/flash_bwd.cu",
               "comat_tpu/ops/flash_attention.py:179", "comat_flash_bwd_dkv",
               (BH, Sq, Skv, d, dtype), err=max(errs[1:]),
               times=(time_ms(torch, lambda: fa.flash_attention_bwd_dkv(*args)),
                      plain, lib),
               flops=8.0 * BH * Sq * Skv * d, nbytes=in_bytes + 2 * BH * Skv * d * e,
               **common),
    ]
    return out


def check_conv_fwd(torch, cv, gen, B, Hs, C, Cout, dtype):
    import torch.nn.functional as F

    dt = getattr(torch, dtype)
    x = torch.randn(B, Hs, Hs, C, generator=gen, device="cuda").to(dt)
    w = (torch.randn(3, 3, C, Cout, generator=gen, device="cuda")
         / math.sqrt(9 * C)).to(dt)
    want = cv.conv3x3_ref(x, w)
    err = check_close("conv3x3", cv.conv3x3_same(x, w), want, dtype)
    x_nchw = x.permute(0, 3, 1, 2)              # channels_last view
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    library = lambda: F.conv2d(x_nchw, w_oihw, padding=1)  # noqa: E731
    lib_err = _library_err(library().permute(0, 2, 3, 1), want)
    del want
    times = (time_ms(torch, lambda: cv.conv3x3_fwd(x, w)),
             time_ms(torch, lambda: cv.conv3x3_ref(x, w)),
             time_ms(torch, library))
    nbytes = (B * Hs * Hs * (C + Cout) + 9 * C * Cout) * x.element_size()
    return [_entry("conv3x3_fwd", "comat_tpu_torch/csrc/conv3x3.cu",
                   "comat_tpu/ops/conv3x3.py:116", "comat_conv3x3_fwd",
                   (B, Hs, Hs, C, Cout, dtype, "fwd"), [B, Hs, Hs, C, Cout], dtype,
                   err, times, conv_ops(B, Hs, C, Cout, dtype), nbytes, "F.conv2d",
                   library_max_abs_err=lib_err,
                   also_replaces="comat_tpu/ops/conv3x3.py:101")]


def _library_err(got, want) -> float:
    """max |library - plain|: shows the library call's precision (TF32
    would stand out at ~1e-3 of the values in fp32)."""
    return float((got.float() - want.float()).abs().max())


def _conv_inputs(torch, gen, B, Hs, C, Cout, dt):
    x = torch.randn(B, Hs, Hs, C, generator=gen, device="cuda").to(dt)
    w = (torch.randn(3, 3, C, Cout, generator=gen, device="cuda")
         / math.sqrt(9 * C)).to(dt)
    dy = torch.randn(B, Hs, Hs, Cout, generator=gen, device="cuda").to(dt)
    return x, w, dy


def check_conv_dx(torch, cv, gen, B, Hs, C, Cout, dtype):
    """dx through the autograd Function (kernel B on dy with the flipped
    io-transposed weights) against the plain vjp (autograd of conv3x3_ref
    in fp32 on the same values)."""
    dt = getattr(torch, dtype)
    x, w, dy = _conv_inputs(torch, gen, B, Hs, C, Cout, dt)
    xg = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad(cv.conv3x3_same(xg, w), xg, dy)
    xp = x.float().requires_grad_()
    (dx_ref,) = torch.autograd.grad(cv.conv3x3_ref(xp, w.float()), xp, dy.float())
    err = check_close("conv dx", dx, dx_ref, dtype)
    wf = cv.flip_io(w)
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    library = lambda: torch.nn.grad.conv2d_input(  # noqa: E731
        (B, C, Hs, Hs), w_oihw, dy.permute(0, 3, 1, 2), padding=1)
    lib_err = _library_err(library().permute(0, 2, 3, 1), dx_ref)
    del dx, dx_ref, xg, xp
    times = (
        time_ms(torch, lambda: cv.conv3x3_fwd(dy, wf, "dx")),
        time_ms(torch, lambda: cv.conv3x3_ref(dy, wf)),
        time_ms(torch, library),
    )
    nbytes = (B * Hs * Hs * (C + Cout) + 9 * C * Cout) * x.element_size()
    return [_entry("conv3x3_dx", "comat_tpu_torch/csrc/conv3x3.cu",
                   "comat_tpu/ops/conv3x3.py:116", "comat_conv3x3_fwd",
                   (B, Hs, Hs, Cout, C, dtype, "dx"), [B, Hs, Hs, Cout, C], dtype,
                   err, times, conv_ops(B, Hs, C, Cout, dtype), nbytes,
                   "torch.nn.grad.conv2d_input", library_max_abs_err=lib_err,
                   note="dx of the 3x3 conv: kernel B (conv3x3.cu) on dy with "
                        "flip_io(w), as _vjp_bwd comat_tpu/ops/conv3x3.py:244-245")]


def check_conv_dw(torch, cv, gen, B, Hs, C, Cout, dtype):
    """dw against `conv3x3_dw_ref`; dy is scaled by 1/sqrt(B*H*W) so that
    dw is of order one."""
    dt = getattr(torch, dtype)
    x, _, dy = _conv_inputs(torch, gen, B, Hs, C, Cout, dt)
    dys = (dy.float() / math.sqrt(B * Hs * Hs)).to(dt)
    want = cv.conv3x3_dw_ref(x, dys, dt)
    err = check_close("conv dw", cv.conv3x3_dw(x, dys, dt), want, dtype)
    x_nchw, dys_nchw = x.permute(0, 3, 1, 2), dys.permute(0, 3, 1, 2)
    library = lambda: torch.nn.grad.conv2d_weight(  # noqa: E731
        x_nchw, (Cout, C, 3, 3), dys_nchw, padding=1)
    lib_err = _library_err(library().permute(2, 3, 1, 0), want)
    del want
    times = (
        time_ms(torch, lambda: cv.conv3x3_dw(x, dys, dt)),
        time_ms(torch, lambda: cv.conv3x3_dw_ref(x, dys, dt)),
        time_ms(torch, library),
    )
    nbytes = (B * Hs * Hs * (C + Cout) + 9 * C * Cout) * x.element_size()
    return [_entry("conv3x3_dw", "comat_tpu_torch/csrc/conv3x3_dw.cu",
                   "comat_tpu/ops/conv3x3.py:128", "comat_conv3x3_dw",
                   (B, Hs, Hs, C, Cout, dtype), [B, Hs, Hs, C, Cout], dtype, err,
                   times, conv_ops(B, Hs, C, Cout, dtype), nbytes,
                   "torch.nn.grad.conv2d_weight", library_max_abs_err=lib_err)]


def phase_kernels(torch, fa, cv):
    entries = []
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dtype in ("float32", "bfloat16"):
        val = VAL_FLASH if dtype == "bfloat16" else []
        for shape in GEN_FLASH + TRAIN_FLASH + val + [RAGGED_FLASH]:
            entries += check_flash_fwd(torch, fa, gen, shape, dtype)
            _log_entry(entries[-1])
            torch.cuda.empty_cache()
        half = HALF_BATCH_FLASH if dtype == "bfloat16" else []
        for shape in TRAIN_FLASH + half + [RAGGED_FLASH]:
            entries += check_flash_bwd(torch, fa, gen, shape, dtype)
            _log_entry(entries[-2])
            _log_entry(entries[-1])
            torch.cuda.empty_cache()
        for Hs, C, Cout in DECODER_CONVS:
            entries += check_conv_fwd(torch, cv, gen, GEN_BATCH, Hs, C, Cout, dtype)
            _log_entry(entries[-1])
            if dtype == "bfloat16":
                # the train step's decode, and validation's at batch 1
                for B in (TRAIN_BATCH, 1):
                    entries += check_conv_fwd(torch, cv, gen, B, Hs, C, Cout, dtype)
                    _log_entry(entries[-1])
            entries += check_conv_dx(torch, cv, gen, TRAIN_BATCH, Hs, C, Cout, dtype)
            _log_entry(entries[-1])
            entries += check_conv_dw(torch, cv, gen, TRAIN_BATCH, Hs, C, Cout, dtype)
            _log_entry(entries[-1])
            torch.cuda.empty_cache()
    # the encoder's own shapes, where phase 9 encodes the latent store
    for Hs, C, Cout in ENCODER_CONVS:
        entries += check_conv_fwd(torch, cv, gen, TRAIN_BATCH, Hs, C, Cout, "bfloat16")
        _log_entry(entries[-1])
    # dw where the train step runs it: the VAE trained, in phase 4's run
    for Hs, C, Cout in PARITY_DW_CONVS:
        entries += check_conv_dw(torch, cv, gen, 1, Hs, C, Cout, "float32")
        _log_entry(entries[-1])
    return entries


def fp32_config(name: str, resolution: int, lora_rank: int = 0):
    import torch

    from comat_tpu_torch.models.pipeline import make_pipeline_config

    cfg = make_pipeline_config(name, lora_rank=lora_rank, resolution=resolution)
    f32 = lambda c: dataclasses.replace(c, dtype=torch.float32)  # noqa: E731
    return dataclasses.replace(
        cfg, unet=f32(cfg.unet), text=f32(cfg.text), vae=f32(cfg.vae)
    )


def reset(kernels) -> None:
    for kern in kernels:
        kern.reset_counts()


def counts_by_role(fa, cv):
    """Launches since the last reset, by kernel and role."""
    conv = cv.KERNEL.launches_by_shape
    return {
        "flash_fwd": fa.KERNEL.launches, "dq": fa.DQ_KERNEL.launches,
        "dkv": fa.DKV_KERNEL.launches,
        "conv_fwd": sum(n for k, n in conv.items() if k[-1] == "fwd"),
        "conv_dx": sum(n for k, n in conv.items() if k[-1] == "dx"),
        "dw": cv.DW_KERNEL.launches,
    }


def phase_parity(torch, kernels):
    from comat_tpu_torch.models.pipeline import DiffusionPipeline
    from comat_tpu_torch.text.tokenizer import HashTokenizer

    cfg = fp32_config("sd_1_5", 256)
    t0 = time.perf_counter()
    cpu = DiffusionPipeline(cfg, device="cpu", seed=SEED)
    gpu = DiffusionPipeline(cfg, device="cuda", params=cpu.state_dicts())
    log(f"  weights made in {time.perf_counter() - t0:.1f} s")
    tok = HashTokenizer(cfg.text.vocab_size)
    enc, null = tok(["a red cube on top of a blue sphere"]), tok([""])
    g = torch.Generator().manual_seed(SEED)
    latents0 = torch.randn(1, 32, 32, 4, generator=g)
    noise = torch.randn(2, 1, 32, 32, 4, generator=g)
    kw = dict(num_inference_steps=2, guidance_scale=7.5,
              eos_positions=enc["eos_positions"], latents0=latents0,
              step_noise=noise)
    t0 = time.perf_counter()
    img_cpu = cpu.generate(enc["input_ids"], null["input_ids"], **kw)
    t_cpu = time.perf_counter() - t0
    del cpu
    reset(kernels)
    t0 = time.perf_counter()
    img_gpu = gpu.generate(enc["input_ids"], null["input_ids"], **kw)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    counts = [kern.launches for kern in kernels[:1] + kernels[3:4]]
    diff = float((img_gpu.cpu() - img_cpu).abs().max())
    log(f"  card vs CPU image max |diff| = {diff:.3e} (cpu {t_cpu:.1f} s, "
        f"card {t_gpu:.1f} s); launches flash {counts[0]}, conv {counts[1]}")
    if not (img_gpu.shape == (1, 256, 256, 3) and torch.isfinite(img_gpu).all()):
        raise AssertionError(f"bad parity image {tuple(img_gpu.shape)}")
    if not diff <= 1e-3:
        raise AssertionError(f"card vs CPU image differs by {diff:.3e} > 1e-3")
    if counts != [PARITY_FLASH_LAUNCHES, PARITY_CONV_LAUNCHES]:
        raise AssertionError(
            f"parity run launched {counts}, expected "
            f"{[PARITY_FLASH_LAUNCHES, PARITY_CONV_LAUNCHES]}"
        )
    del gpu
    torch.cuda.empty_cache()
    return diff


def _train_batch(prompts, clip_vocab, blip_vocab):
    from comat_tpu_torch.losses.caption_reward import build_caption_batch
    from comat_tpu_torch.text.tokenizer import HashTokenizer

    tok = HashTokenizer(clip_vocab)
    enc, null = tok(prompts), tok([""] * len(prompts))
    cap = build_caption_batch(HashTokenizer(blip_vocab), prompts)
    return {"input_ids": enc["input_ids"], "eos_positions": enc["eos_positions"],
            "null_ids": null["input_ids"], "caption_ids": cap["input_ids"],
            "caption_mask": cap["attention_mask"], "caption_labels": cap["labels"]}


def _attrcon_fields(prompts, clip_vocab, resolution):
    """The batch fields of attribute concentration: token groups and
    CenterPrior masks (uint8, (B, 8, resolution, resolution))."""
    from comat_tpu_torch.segmentation.interface import CenterPriorSegmenter, SegmenterHolder
    from comat_tpu_torch.text.tokenizer import HashTokenizer
    from comat_tpu_torch.training.attrcon import attrcon_batch_fields

    holder = SegmenterHolder(CenterPriorSegmenter())
    fields = attrcon_batch_fields(prompts, HashTokenizer(clip_vocab), holder, 77,
                                  resolution=resolution)
    return holder, fields


def _nonzero_lora_b(torch, module, gen) -> None:
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))


def _d_own(disc):
    """D's own tensors (its LoRA and head), not the base it shares."""
    return {n: v for n, v in disc.state_dict().items()
            if "lora_" in n or n.startswith("head.")}


def phase_train_parity(torch, fa, cv, kernels):
    """One make_loss_fn value and backward, then D's loss and backward at
    its latents (what the step's D update differentiates), on the card and
    on the CPU."""
    from comat_tpu_torch.config import BLIPConfig
    from comat_tpu_torch.diffusion.schedulers import inference_timesteps
    from comat_tpu_torch.losses.gan import Discriminator, GanConfig, gan_d_loss
    from comat_tpu_torch.models.blip import make_blip
    from comat_tpu_torch.models.pipeline import DiffusionPipeline
    from comat_tpu_torch.training import train_step as ts
    from comat_tpu_torch.training.attrcon import make_attrcon_extra_losses

    cfg = dataclasses.replace(fp32_config("sd_1_5_attrcon", 256, lora_rank=128),
                              capture_layers=PARITY_CAPTURE)
    bcfg = dataclasses.replace(BLIPConfig.large(), dtype=torch.float32)
    tcfg = ts.TrainConfig(total_step=4, K=2, resolution=256, gan_loss=True, attrcon=True)
    gan_cfg = GanConfig(lora_rank=128)
    t0 = time.perf_counter()
    cpu = DiffusionPipeline(cfg, device="cpu", seed=SEED)
    g = torch.Generator().manual_seed(SEED + 11)
    _nonzero_lora_b(torch, cpu.unet, g)
    d_cpu = Discriminator(cfg.unet, gan_cfg, device="cpu", base_unet=cpu.unet, seed=SEED + 7)
    _nonzero_lora_b(torch, d_cpu, g)
    gpu = DiffusionPipeline(cfg, device="cuda", params=cpu.state_dicts())
    d_gpu = Discriminator(cfg.unet, gan_cfg, device="cuda", base_unet=gpu.unet)
    d_gpu.load_state_dict(_d_own(d_cpu), strict=False)
    blip_cpu = make_blip(bcfg, device="cpu", seed=SEED + 1)
    blip_gpu = make_blip(bcfg, device="cuda", params=blip_cpu.state_dict())
    log(f"  weights made in {time.perf_counter() - t0:.1f} s")
    prompts = TRAIN_PROMPTS[:1]
    batch = _train_batch(prompts, cfg.text.vocab_size, bcfg.vocab_size)
    holder, fields = _attrcon_fields(prompts, cfg.text.vocab_size, 256)
    batch.update(fields)
    gt = torch.randn(1, 32, 32, 4, generator=torch.Generator().manual_seed(SEED + 9))
    draws = ts.sample_draws(tcfg, 1, cfg.latent_size,
                            torch.Generator().manual_seed(SEED + 3))
    t_final = int(inference_timesteps(tcfg.total_step)[-1])
    log(f"  draws: start {draws.start}, crop {draws.crop}, attrcon "
        f"{draws.attrcon_draws}; {int(fields['word_valid'].sum())} words")

    def run(pipe, blip, disc):
        trainable = ts.partition_params(pipe, tune_vae=True)
        d_trainable = ts.partition_disc_params(disc)
        dev = pipe.device
        d = draws._replace(latents0=draws.latents0.to(dev),
                           step_noise=draws.step_noise.to(dev))
        extra = make_attrcon_extra_losses(pipe, holder, tcfg)
        loss, (metrics, latents) = ts.make_loss_fn(pipe, blip, tcfg, extra, disc)(batch, d)
        loss.backward()
        null = pipe.encode_prompt(batch["null_ids"]).context
        d_loss = gan_d_loss(disc, latents, gt.to(dev), t_final, null)
        d_loss.backward()
        metrics["D_loss"] = d_loss.detach()
        # the VAE encoder, trained but never run by the step, has none
        unreached = [n for n, p in trainable.items() if p.grad is None]
        if not all(n.startswith(("vae.encoder.", "vae.quant_conv.")) for n in unreached):
            raise AssertionError(f"trainable tensors without gradient: {unreached[:5]}")
        grads = {n: p.grad.detach().cpu() for n, p in trainable.items()
                 if p.grad is not None}
        grads.update({f"disc.{n}": p.grad.detach().cpu() for n, p in d_trainable.items()})
        return {k: float(v) for k, v in metrics.items()}, grads

    t0 = time.perf_counter()
    metrics_cpu, grads_cpu = run(cpu, blip_cpu, d_cpu)
    t_cpu = time.perf_counter() - t0
    del cpu, blip_cpu, d_cpu
    reset(kernels)
    t0 = time.perf_counter()
    metrics_gpu, grads_gpu = run(gpu, blip_gpu, d_gpu)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    counts = counts_by_role(fa, cv)
    by_shape = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
    scale = max(float(g.abs().max()) for g in grads_cpu.values())
    rels, zero_leaves = {}, {}
    for name, gc in grads_cpu.items():
        gg, gc = grads_gpu[name].double(), gc.double()
        peak = max(float(gg.abs().max()), float(gc.abs().max()))
        if float(gc.abs().max()) < ZERO_LEAF_REL * scale:
            zero_leaves[name] = peak / scale
        else:
            rels[name] = float((gg - gc).abs().max()) / max(peak, 1e-12)
    worst_name = max(rels, key=rels.get)
    worst = rels[worst_name]
    n_lora = sum("lora_" in n and not n.startswith("disc.") for n in grads_cpu)
    n_disc = sum(n.startswith("disc.") for n in grads_cpu)
    diffs = {k: abs(metrics_gpu[k] - metrics_cpu[k]) for k in metrics_cpu}
    log(f"  card {metrics_gpu}")
    log(f"  CPU  {metrics_cpu}")
    log(f"  |card - CPU| {diffs}; {len(grads_cpu)} gradient leaves ({n_lora} LoRA, "
        f"{n_disc} D, {len(grads_cpu) - n_lora - n_disc} VAE), worst relative "
        f"{worst:.3e} at {worst_name} (cpu {t_cpu:.1f} s, card {t_gpu:.1f} s)")
    lora_worst = max(r for n, r in rels.items() if "lora_" in n and not n.startswith("disc."))
    d_worst = max((r for n, r in rels.items() if n.startswith("disc.")), default=0.0)
    log(f"  worst LoRA leaf {lora_worst:.3e}, worst D leaf {d_worst:.3e}; zero-gradient "
        f"leaves, largest |g| over the largest gradient: {zero_leaves}")
    log(f"  launches {counts}")
    want_keys = {"step_loss", "reward_blip", "G_loss", "token_loss", "pixel_loss", "D_loss"}
    if not want_keys <= set(metrics_gpu):
        raise AssertionError(f"train parity metrics lack {want_keys - set(metrics_gpu)}")
    if not all(math.isfinite(metrics_gpu[k]) and diffs[k] <= LOSS_TOL for k in want_keys):
        raise AssertionError(f"train loss components card vs CPU differ: {diffs}")
    if not worst <= GRAD_TOL:
        raise AssertionError(f"gradient {worst_name} differs by {worst:.3e} relative")
    if not all(r <= ZERO_LEAF_TOL for r in zero_leaves.values()):
        raise AssertionError(f"zero-gradient leaves are not at noise level: {zero_leaves}")
    if counts != PARITY_TRAIN_LAUNCHES:
        raise AssertionError(f"train parity launched {counts}, "
                             f"expected {PARITY_TRAIN_LAUNCHES}")
    del gpu, blip_gpu, d_gpu
    torch.cuda.empty_cache()
    return by_shape


def phase_main(torch, kernels):
    from comat_tpu_torch.tools.generate import main as generate_main

    out_dir = os.path.join(REPO, "build", "chip_smoke")   # PNGs; build/ is ignored
    argv = [
        "--model", "sd_1_5", "--resolution", "512",
        "--num-inference-steps", "50", "--guidance-scale", "7.5",
        "--scheduler", "ddpm", "--seed", str(SEED), "--device", "cuda",
        "--out-dir", out_dir,
        "--prompt", "a red cube on top of a blue sphere",
        "a photo of two cats and a green umbrella",
    ]
    reset(kernels)
    t0 = time.perf_counter()
    images, timings = generate_main(argv)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    by_shape = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
    counts = [kernels[0].launches, kernels[3].launches]
    log(f"  main path: {total:.1f} s in all, {timings['sample_s'] / 50:.4f} s/step, "
        f"decode {timings['decode_s']:.3f} s; launches flash {counts[0]}, "
        f"conv {counts[1]}")
    if tuple(images.shape) != (2, 512, 512, 3) or not torch.isfinite(images).all():
        raise AssertionError(f"bad images {tuple(images.shape)}")
    if counts != [MAIN_FLASH_LAUNCHES, MAIN_CONV_LAUNCHES]:
        raise AssertionError(
            f"main path launched {counts}, expected "
            f"{[MAIN_FLASH_LAUNCHES, MAIN_CONV_LAUNCHES]}"
        )
    return by_shape


def run_train_steps(torch, fa, cv, kernels, step, state, batch, gen, n_steps, what):
    """`n_steps` train steps, every launch count set to 0 just before.
    Returns (state, launches by role, launches by kernel and shape, peak
    memory GiB, medians of steps 2-n)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    steps = []
    for i in range(n_steps):
        t0 = time.perf_counter()
        state, m = step(state, batch, generator=gen)
        torch.cuda.synchronize()
        m["wall_s"] = time.perf_counter() - t0
        steps.append(m)
        log(f"  step {i + 1}: loss {m['step_loss']:.4f}, reward_blip "
            f"{m['reward_blip']:.4f}, reward_norm {m['reward_norm']:.4e}, "
            f"grad_norm {m['grad_norm']:.4e}; {m['wall_s']:.3f} s wall, "
            f"device split: pass 1 {m['s_pass1']:.3f} s, pass 2 {m['s_pass2']:.3f} s, "
            f"decode {m['s_decode']:.3f} s, reward {m['s_reward']:.3f} s, "
            f"optimizer {m['s_optimizer']:.3f} s")
    counts = counts_by_role(fa, cv)
    by_shape = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    late = steps[1:]
    median = {k: sorted(s[k] for s in late)[len(late) // 2] if len(late) % 2
              else sum(s[k] for s in late) / len(late)
              for k in ("wall_s", "s_pass1", "s_pass2", "s_decode", "s_reward",
                        "s_optimizer")}
    log(f"  {what} split (median of steps 2-{n_steps}): pass 1 "
        f"{median['s_pass1']:.3f} s, pass 2 {median['s_pass2']:.3f} s, decode "
        f"{median['s_decode']:.3f} s, reward {median['s_reward']:.3f} s, optimizer "
        f"{median['s_optimizer']:.3f} s")
    log(f"  {what}: {median['wall_s']:.3f} s per step (median of steps "
        f"2-{n_steps}), peak memory {peak:.1f} GiB; launches {counts}")
    for m in steps:
        if not (math.isfinite(m["step_loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"non-finite {what} step: {m}")
    return state, counts, by_shape, peak, median


def phase_train_main(torch, fa, cv, kernels):
    """The recipe's train steps. Returns (launches by kernel and shape,
    medians, (pipeline, BLIP, batch)) for phase 7 to reuse."""
    from comat_tpu_torch.config import BLIPConfig
    from comat_tpu_torch.models.blip import make_blip
    from comat_tpu_torch.models.pipeline import DiffusionPipeline, make_pipeline_config
    from comat_tpu_torch.training import train_step as ts

    cfg = make_pipeline_config("sd_1_5", lora_rank=128, resolution=512)
    bcfg = BLIPConfig.large()
    tcfg = ts.TrainConfig()                    # scripts/sd15.sh
    t0 = time.perf_counter()
    pipe = DiffusionPipeline(cfg, device="cuda", seed=SEED)
    blip = make_blip(bcfg, device="cuda", seed=SEED + 1)
    state = ts.init_train_state(pipe, tcfg)
    step = ts.make_train_step(pipe, blip, tcfg)
    batch = _train_batch(TRAIN_PROMPTS, cfg.text.vocab_size, bcfg.vocab_size)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    before = {n: p.detach().clone() for n, p in state.trainable.items()}
    torch.cuda.synchronize()
    log(f"  weights made in {time.perf_counter() - t0:.1f} s; "
        f"{len(before)} LoRA leaves, "
        f"{sum(p.numel() for p in before.values()) / 1e6:.1f} M parameters")
    state, counts, by_shape, _, median = run_train_steps(
        torch, fa, cv, kernels, step, state, batch, gen, TRAIN_STEPS, "train")
    changed = sum(not torch.equal(before[n], p.detach())
                  for n, p in state.trainable.items())
    log(f"  {changed} of {len(before)} LoRA leaves changed")
    if changed != len(before):
        raise AssertionError(f"only {changed} of {len(before)} LoRA leaves changed")
    want = {k: n * TRAIN_STEPS for k, n in TRAIN_LAUNCHES.items()}
    if counts != want:
        raise AssertionError(f"train main path launched {counts}, expected {want}")
    return by_shape, median, (pipe, blip, batch)


def phase_train_tune_vae(torch, fa, cv, kernels, pipe, blip, batch):
    """Phase 6's recipe on its pipeline with the VAE trained: the bf16
    decoder through fp32 masters (its stored weights upcast), every gated
    decoder conv's dw in bf16. Returns (launches by kernel and shape,
    medians, peak memory GiB)."""
    from comat_tpu_torch.training import train_step as ts

    tcfg = ts.TrainConfig()
    state = ts.init_train_state(pipe, tcfg, tune_vae=True)
    step = ts.make_train_step(pipe, blip, tcfg)
    masters = state.optimizer.masters
    before = {n: m.detach().clone() for n, m in masters.items()}
    bf16 = [n for n, p in state.trainable.items() if p.dtype == torch.bfloat16]
    n_vae = sum(n.startswith("vae.") for n in before)
    log(f"  {len(before)} trainable leaves ({n_vae} VAE, {len(bf16)} bf16 with "
        f"fp32 masters), {sum(m.numel() for m in before.values()) / 1e6:.1f} M "
        f"parameters")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    state, counts, by_shape, peak, median = run_train_steps(
        torch, fa, cv, kernels, step, state, batch, gen, TUNE_VAE_STEPS,
        "train_tune_vae_bf16")
    # the encoder takes weight decay alone, which leaves a zero tensor zero
    zero = [n for n, m in masters.items()
            if n.startswith(("vae.encoder.", "vae.quant_conv.")) and not m.any()]
    unchanged = [n for n, m in masters.items()
                 if torch.equal(before[n], m) and n not in zero]
    stale = [n for n in bf16
             if not torch.equal(state.trainable[n].detach(), masters[n].bfloat16())]
    moved = sum(not torch.equal(before[n].bfloat16(), state.trainable[n].detach())
                for n in bf16)
    dw_dtypes = {k[-1] for k in cv.DW_KERNEL.launches_by_shape}
    log(f"  {len(masters) - len(unchanged) - len(zero)} of {len(masters)} masters "
        f"changed, {len(zero)} zero encoder tensors stayed zero; "
        f"{moved} of {len(bf16)} bf16 working copies moved; dw dtypes {dw_dtypes}")
    if unchanged:
        raise AssertionError(f"{len(unchanged)} masters did not change: {unchanged[:5]}")
    if stale or not bf16 or n_vae == 0:
        raise AssertionError(f"bf16 working copies not their rounded masters: {stale[:5]}")
    want = {k: n * TUNE_VAE_STEPS for k, n in TUNE_VAE_LAUNCHES.items()}
    if counts != want or dw_dtypes != {"bfloat16"}:
        raise AssertionError(f"tune_vae path launched {counts} (dw {dw_dtypes}), "
                             f"expected {want}, bf16")
    return by_shape, median, peak


def phase_train_full(torch, fa, cv, kernels, pipe, blip, batch):
    """The full recipe on phase 6's pipeline and BLIP: a fresh G state, D
    sharing G's base, FULL_STEPS steps, each marked on a PhaseClock whose
    probe reads the launch counters. Returns (launches by kernel and
    shape, medians, peak memory GiB)."""
    from comat_tpu_torch.losses.gan import Discriminator, GanConfig
    from comat_tpu_torch.training import train_step as ts
    from comat_tpu_torch.training.attrcon import make_attrcon_extra_losses

    cfg = pipe.cfg
    tcfg = ts.TrainConfig(gan_loss=True, attrcon=True)      # scripts/sd15.sh
    disc = Discriminator(cfg.unet, GanConfig(lora_rank=128), device="cuda",
                         base_unet=pipe.unet, seed=SEED + 7)
    state = ts.init_train_state(pipe, tcfg)
    d_state = ts.init_disc_state(disc, tcfg)
    holder, fields = _attrcon_fields(TRAIN_PROMPTS, cfg.text.vocab_size, cfg.resolution)
    batch = dict(batch, **{k: torch.from_numpy(v).cuda() for k, v in fields.items()})
    batch["gt_latents"] = torch.randn(
        TRAIN_BATCH, cfg.latent_size, cfg.latent_size, 4, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED + 9))
    step = ts.make_train_step(pipe, blip, tcfg, make_attrcon_extra_losses(pipe, holder, tcfg),
                              disc, d_state.optimizer)
    before = {n: p.detach().clone() for n, p in state.trainable.items()}
    d_before = {n: p.detach().clone() for n, p in d_state.trainable.items()}
    shared = sum(p is q for p, q in zip(disc.unet.parameters(), pipe.unet.parameters()))
    log(f"  {len(before)} LoRA leaves; D: {len(d_before)} trainable leaves "
        f"({sum(p.numel() for p in d_before.values()) / 1e6:.1f} M parameters), "
        f"{shared} base tensors shared with G; {int(fields['word_valid'].sum())} words")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    steps, roles = [], {role: {} for role in FULL_ROLES}
    for i in range(FULL_STEPS):
        clock = ts.PhaseClock(torch.device("cuda"), probe=lambda: counts_by_role(fa, cv))
        t0 = time.perf_counter()
        state, m = step(state, batch, generator=gen, clock=clock)
        torch.cuda.synchronize()
        m["wall_s"] = time.perf_counter() - t0
        steps.append(m)
        for role, segs in FULL_ROLES.items():
            for seg in segs:
                for k, n in clock.counts(*ts.SEGMENTS[seg]).items():
                    roles[role][k] = roles[role].get(k, 0) + n
        log(f"  step {i + 1}: loss {m['step_loss']:.4f}, reward_blip "
            f"{m['reward_blip']:.4f}, G_loss {m['G_loss']:.4f}, token_loss "
            f"{m['token_loss']:.4f}, pixel_loss {m['pixel_loss']:.4f}, D_loss "
            f"{m['D_loss']:.4f}, grad_norm {m['grad_norm']:.4e}; {m['wall_s']:.3f} s "
            f"wall; " + ", ".join(f"{k} {m[k]:.3f}" for k in ts.PHASES))
    counts = counts_by_role(fa, cv)
    by_shape = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    late = steps[1:]
    median = {k: sorted(s[k] for s in late)[len(late) // 2] if len(late) % 2
              else sum(s[k] for s in late) / len(late)
              for k in ("wall_s", "s_step", *ts.PHASES)}
    log(f"  train_full split (median of steps 2-{FULL_STEPS}): "
        + ", ".join(f"{k} {median[k]:.3f} s" for k in ts.PHASES))
    log(f"  train_full: {median['wall_s']:.3f} s per step (median of steps "
        f"2-{FULL_STEPS}), peak memory {peak:.1f} GiB; launches {counts}")
    for role, c in roles.items():
        log(f"  launches by role, {FULL_STEPS} steps: {role} "
            f"{ {k: n for k, n in c.items() if n} }")
    keys = ("step_loss", "reward_blip", "G_loss", "token_loss", "pixel_loss",
            "D_loss", "grad_norm")
    for m in steps:
        if not all(math.isfinite(m[k]) for k in keys):
            raise AssertionError(f"non-finite full-recipe step: {m}")
    still = [n for n, p in state.trainable.items() if torch.equal(before[n], p.detach())]
    d_still = [n for n, p in d_state.trainable.items()
               if torch.equal(d_before[n], p.detach())]
    log(f"  {len(before) - len(still)} of {len(before)} LoRA leaves and "
        f"{len(d_before) - len(d_still)} of {len(d_before)} D leaves changed")
    if still or d_still:
        raise AssertionError(f"leaves did not change: G {still[:5]}, D {d_still[:5]}")
    want_roles = {role: {k: n * FULL_STEPS for k, n in c.items()}
                  for role, c in FULL_LAUNCHES.items()}
    got_roles = {role: {k: n for k, n in c.items() if n} for role, c in roles.items()}
    want = {k: sum(c.get(k, 0) for c in want_roles.values()) for k in counts}
    if counts != want or got_roles != want_roles:
        raise AssertionError(f"full recipe launched {counts} ({got_roles}), "
                             f"expected {want} ({want_roles})")
    del disc, d_state
    return by_shape, median, peak


def encode_latent_store(torch, fa, cv, kernels, out_dir, prompts_path):
    """The GAN's latent store for phase 9: the SD1.5 VAE encoder (bf16,
    seeded weights) encodes 4 seeded 512^2 images on the card; their
    means times the scaling factor are written as (64, 64, 4) .npy files
    and indexed (jsonl) for every training prompt, round robin. Returns
    (index path, launches by kernel and shape)."""
    from comat_tpu_torch.config import VAEConfig
    from comat_tpu_torch.models.vae import AutoencoderKL
    from comat_tpu_torch.training.data import load_prompts
    from comat_tpu_torch.weights import init_weights_

    cfg = VAEConfig.sd15()
    with torch.device("meta"):
        vae = AutoencoderKL(cfg)
    vae = vae.to_empty(device="cuda").eval().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    init_weights_(vae, gen)
    images = torch.rand(TRAIN_BATCH, 512, 512, 3, generator=gen, device="cuda") * 2 - 1
    reset(kernels)
    with torch.no_grad():
        mean, logvar = vae.encode(images)
    torch.cuda.synchronize()
    counts = {k: n for k, n in counts_by_role(fa, cv).items() if n}
    by_shape = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
    latents = (mean * cfg.scaling_factor).float().cpu().numpy()
    log(f"  encoded {TRAIN_BATCH} images to {latents.shape}, latent std "
        f"{latents.std():.4f}; launches {counts}")
    if latents.shape != (TRAIN_BATCH, 64, 64, 4) or not (
            torch.isfinite(mean).all() and torch.isfinite(logvar).all()):
        raise AssertionError(f"bad encoder output {latents.shape}")
    if counts != ENCODE_LAUNCHES:
        raise AssertionError(f"encoding launched {counts}, expected {ENCODE_LAUNCHES}")
    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    for i, lat in enumerate(latents):
        np.save(os.path.join(out_dir, f"latent_{i}.npy"), lat)
    index = os.path.join(out_dir, "index.jsonl")
    with open(index, "w") as f:
        for j, p in enumerate(load_prompts(prompts_path)):
            f.write(json.dumps({"prompt": p, "file_path": f"latent_{j % TRAIN_BATCH}.npy"})
                    + "\n")
    del vae, images
    return index, by_shape


def _median(rows, keys):
    return {k: sorted(r[k] for r in rows)[len(rows) // 2] if len(rows) % 2
            else sum(r[k] for r in rows) / len(rows) for k in keys}


def _cli_roles(trainer):
    """Launches by role over the trainer's steps, from its clocks."""
    roles = {}
    for role, segs in FULL_ROLES.items():
        acc = {}
        for seg in segs:
            for k, n in trainer.segment_counts.get(seg, {}).items():
                acc[k] = acc.get(k, 0) + n
        roles[role] = {k: n for k, n in acc.items() if n}
    return roles


def phase_trainer_cli(torch, fa, cv, kernels, full_median, full_peak):
    """The trainer CLI with scripts/sd15.sh's flags at 512^2, then a resume
    from its checkpoint. Returns (launches by kernel and shape of the
    trainer's runs, of the latent store's encoding)."""
    from comat_tpu_torch.train import main as train_main
    from comat_tpu_torch.training import train_step as ts
    from comat_tpu_torch.training.arguments import launcher_argv, parse_args
    from comat_tpu_torch.training.trainer import Trainer

    work = os.path.join(REPO, "build", "chip_smoke", "trainer")   # build/ is ignored
    shutil.rmtree(work, ignore_errors=True)
    argv = launcher_argv(os.path.join(REPO, SD15_LAUNCHER))
    i = argv.index("--training_prompts") + 1
    argv[i] = os.path.join(REPO, argv[i])
    index, encode_shapes = encode_latent_store(torch, fa, cv, kernels,
                                               os.path.join(work, "gan_store"), argv[i])
    out = os.path.join(work, "output")
    argv += ["--gan_gt_path", index, "--num_validation_images", "1",
             "--max_train_steps", str(CLI_STEPS), "--validation_steps", str(CLI_RESUME),
             "--checkpoints_total_limit", "2"]
    n_val = 3   # validations at step 0, CLI_RESUME and CLI_STEPS
    argv_first = argv + ["--output_dir", out]
    log("  argv: " + " ".join(argv))
    probe = lambda: counts_by_role(fa, cv)  # noqa: E731
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    trainer = train_main(argv_first, probe=probe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = counts_by_role(fa, cv)
    roles = _cli_roles(trainer)
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    keys = ("s_step", *ts.PHASES)
    for r in rows:
        log(f"  step {r['step']}: loss {r['step_loss']:.4f}, G_loss {r['G_loss']:.4f}, "
            f"D_loss {r['D_loss']:.4f}, token_loss {r['token_loss']:.4f}, grad_norm "
            f"{r['grad_norm']:.4e}, lr {r['lr']:g}; {r['sec_per_step']:.3f} s wall; "
            + ", ".join(f"{k} {r[k]:.3f}" for k in keys))
    median = _median(rows[1:], ("sec_per_step",) + keys)
    # s_capture lies inside s_pass2, s_segment_host inside s_segment
    seg_sum = sum(median[k] for k in ts.PHASES if k not in ("s_capture", "s_segment_host"))
    log(f"  trainer_cli: {median['s_step']:.3f} s per step on the device "
        f"({median['sec_per_step']:.3f} s wall, median of steps 2-{CLI_STEPS}; "
        f"segments sum to {seg_sum:.3f} s), peak memory {peak:.1f} GiB, "
        f"run {wall:.1f} s ({n_val} validation images, {n_val} checkpoints)")
    log("  validation (one prompt, 50 DDPM steps, one fused UNet each): " + ", ".join(
        f"step {step} {sec:.3f} s" for step, sec in trainer.validation_times))
    log(f"  phase 8, same run: {full_median['s_step']:.3f} s per step on the device "
        f"({full_median['wall_s']:.3f} s wall), peak memory {full_peak:.1f} GiB")
    log(f"  split step (median of steps 2-{CLI_STEPS}): presample decode "
        f"{median['s_presample']:.3f} s (pass 1 {median['s_pass1']:.3f} s), Grounded-SAM "
        f"{median['s_segment']:.3f} s: device {median['s_segment'] - median['s_segment_host']:.3f}"
        f" s, host {median['s_segment_host']:.3f} s")
    for k in keys:
        log(f"    {k}: trainer_cli {median[k]:.3f} s, phase 8 {full_median[k]:.3f} s")
    want_roles = {role: {k: n * CLI_STEPS for k, n in c.items()}
                  for role, c in CLI_LAUNCHES.items()}
    if not all(r["s_segment"] > 0 and r["s_presample"] > 0 for r in rows):
        raise AssertionError(f"the trainer did not take the split step: {rows}")
    for role in FULL_ROLES:
        log(f"  launches by role, {CLI_STEPS} steps: {role} {roles[role]} (predicted "
            f"{want_roles[role]}; phase 8 per step { FULL_LAUNCHES[role] })")
    want = {k: sum(c.get(k, 0) for c in want_roles.values())
            + n_val * VALIDATION_LAUNCHES.get(k, 0) for k in counts}
    log(f"  launches in all {counts}, predicted {want} (with {n_val} validation images)")
    if len(rows) != CLI_STEPS or not all(
            math.isfinite(r[k]) for r in rows for k in ("step_loss", "G_loss", "D_loss",
                                                        "token_loss", "pixel_loss",
                                                        "grad_norm")):
        raise AssertionError(f"trainer metrics: {rows}")
    if roles != want_roles or counts != want:
        raise AssertionError(f"trainer launched {counts} ({roles}), expected {want} "
                             f"({want_roles})")
    ckpts = sorted(d for d in os.listdir(out) if d.startswith("checkpoint-"))
    last = os.path.join(out, f"checkpoint-{CLI_STEPS}")
    images = sorted(os.listdir(os.path.join(out, "validation_images")))
    log(f"  {ckpts}, {sorted(os.listdir(last))}; validation images {images}")
    if ckpts != [f"checkpoint-{CLI_RESUME}", f"checkpoint-{CLI_STEPS}"] or not os.path.isfile(
            os.path.join(last, "pytorch_lora_weights.safetensors")) or len(images) != n_val:
        raise AssertionError(f"trainer output: {ckpts}, images {images}")
    cli_shapes = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # resume from checkpoint-3 in a directory of its own: the restored
    # tensors against the saved ones, then step 4 against the
    # uninterrupted run's
    res_out = os.path.join(work, "resumed")
    mid = os.path.join(out, f"checkpoint-{CLI_RESUME}")
    shutil.copytree(mid, os.path.join(res_out, f"checkpoint-{CLI_RESUME}"))
    saved = torch.load(os.path.join(mid, "state.pt"), map_location="cuda",
                       weights_only=True)
    reset(kernels)
    resumed = Trainer(parse_args(argv + ["--output_dir", res_out,
                                         "--resume_from_checkpoint", "latest"]),
                      probe=probe)
    same = (resumed.global_step == CLI_RESUME
            and all(torch.equal(p.detach(), saved["trainable"][n])
                    for n, p in resumed.state.trainable.items())
            and all(torch.equal(p.detach(), saved["d_trainable"][n])
                    for n, p in resumed.d_state.trainable.items())
            and torch.equal(resumed.generator.get_state(), saved["generator"].cpu())
            and resumed.state.optimizer.count == CLI_RESUME
            and resumed.latent_store.rng.getstate() == saved["extra"]["latent_store_rng"])
    log(f"  resumed at step {resumed.global_step}: {len(saved['trainable'])} G and "
        f"{len(saved['d_trainable'])} D tensors, AdamW state, generator and latent "
        f"store draws restored; "
        f"equal to the saved: {same}")
    if not same:
        raise AssertionError("the resumed trainer does not hold the saved state")
    resumed.train()
    torch.cuda.synchronize()
    counts = counts_by_role(fa, cv)
    want = {k: sum(c.get(k, 0) for c in CLI_LAUNCHES.values())
            + VALIDATION_LAUNCHES.get(k, 0) for k in counts}
    row = json.loads(open(os.path.join(res_out, "metrics.jsonl")).read().splitlines()[-1])
    log(f"  resumed step {row['step']}: loss {row['step_loss']:.4f} (uninterrupted "
        f"{rows[-1]['step_loss']:.4f}); launches {counts} (predicted {want})")
    if row["step"] != CLI_STEPS or counts != want:
        raise AssertionError(f"resumed run: step {row['step']}, launches {counts}")
    a = torch.load(os.path.join(last, "state.pt"), weights_only=True)
    b = torch.load(os.path.join(res_out, f"checkpoint-{CLI_STEPS}", "state.pt"),
                   weights_only=True)
    diffs = {}
    for key in ("trainable", "d_trainable"):
        for n in a[key]:
            diffs[f"{key}.{n}"] = (a[key][n].float() - b[key][n].float()).abs().max().item()
    for key in ("optimizer", "d_optimizer"):
        sa, sb = a[key]["adam"]["state"], b[key]["adam"]["state"]
        for i in sa:
            for m in sa[i]:
                if torch.is_tensor(sa[i][m]):
                    diffs[f"{key}.{i}.{m}"] = (sa[i][m].float()
                                               - sb[i][m].float()).abs().max().item()
    worst = max(diffs, key=diffs.get)
    equal = (max(diffs.values()) == 0.0 and torch.equal(a["generator"], b["generator"])
             and a["extra"] == b["extra"] and row["step_loss"] == rows[-1]["step_loss"])
    log(f"  resumed checkpoint-{CLI_STEPS} against the uninterrupted run's: {len(diffs)} "
        f"tensors, largest |delta| {diffs[worst]:.3e} ({worst}); generator, latent store "
        f"draws and step loss equal: {equal}")
    if not equal:
        raise AssertionError("the resumed run's step does not repeat the uninterrupted run's")
    for kern in kernels:
        acc = cli_shapes.setdefault(kern.symbol, {})
        for key, n in kern.launches_by_shape.items():
            acc[key] = acc.get(key, 0) + n
    del resumed, saved, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return cli_shapes, encode_shapes


GSAM_TOL = 1e-3          # relative to each output's max abs
GSAM_NOUNS = [["cube", "sphere"], ["cats", "umbrella"], ["bus", "horse"], ["cups", "table"]]


def _gsam_near_threshold(seg, rows, gd_out, sam_out, tol):
    """Scores of the CPU run within `tol` (in each output's own units) of
    the threshold they are held to: box scores and noun-span maxima
    (token probabilities against box_threshold / text_threshold), FastSAM
    class probabilities against its conf 0.4, and the mask logits of every
    anchor's proposal against 0 (probability 0.5). Returns counts by kind."""
    import numpy as np

    boxes, logits = (t.numpy() for t in gd_out)
    outs, protos = sam_out
    live = logits > -1e29
    prob = 1.0 / (1.0 + np.exp(-np.where(live, logits, -80.0)))
    t_p = tol * float(np.abs(logits[live]).max()) / 4       # sigmoid's slope <= 1/4
    near = {"box_score": int((np.abs(prob.max(-1) - seg.box_threshold) <= t_p).sum())}
    span_max = [prob[b][:, a:e].max(-1) for b, r in enumerate(rows) for a, e in r[5] if e > a]
    near["noun_span"] = int(sum((np.abs(m - seg.text_threshold) <= t_p).sum() for m in span_max))
    cls = np.concatenate([o["cls"].numpy().ravel() for o in outs])
    t_c = tol * float(np.abs(cls).max()) / 4
    near["fastsam_conf"] = int((np.abs(1 / (1 + np.exp(-cls)) - 0.4) <= t_c).sum())
    mask_logits = np.einsum("bhwm,bnm->bnhw", protos.numpy(),
                            np.concatenate([o["mc"].numpy().reshape(len(rows), -1,
                                                                    seg.sam_cfg.num_masks)
                                            for o in outs], 1))
    near["mask_pixel"] = int((np.abs(mask_logits) <= tol * np.abs(mask_logits).max()).sum())
    return near


def phase_gsam(torch):
    """Grounded-SAM at full width, card against CPU in fp32, then the bf16
    batched segmenter at batch 4, its device forwards and host decode
    timed apart. Returns the bf16 timings."""
    import numpy as np

    from comat_tpu_torch.segmentation.fastsam import YoloSegConfig, decode_predictions
    from comat_tpu_torch.segmentation.gdino import GDinoConfig, ground_nouns
    from comat_tpu_torch.segmentation.grounded_sam import GroundedSAMSegmenter, gdino_input

    f32 = dict(sam_cfg=dataclasses.replace(YoloSegConfig.fastsam_x(), dtype=torch.float32),
               gdino_cfg=dataclasses.replace(GDinoConfig.swint_ogc(), dtype=torch.float32),
               gdino_resize=800)
    t0 = time.perf_counter()
    cpu = GroundedSAMSegmenter(device="cpu", seed=SEED + 21, **f32)
    sam_sd, gd_sd = cpu.sam.state_dict(), cpu.gdino.state_dict()
    gpu = GroundedSAMSegmenter(device="cuda", sam_params=sam_sd, gdino_params=gd_sd, **f32)
    n_par = sum(p.numel() for m in (cpu.sam, cpu.gdino) for p in m.parameters())
    log(f"  weights made in {time.perf_counter() - t0:.1f} s: {n_par / 1e6:.1f} M "
        f"parameters (FastSAM-x {sum(p.numel() for p in cpu.sam.parameters()) / 1e6:.1f} M)")
    image = torch.rand(1, 512, 512, 3, generator=torch.Generator().manual_seed(SEED + 23))
    rows = cpu.text_rows(GSAM_NOUNS[:1], 1)

    def run(seg, img, top_idx=None):
        dev = seg.device
        cat = lambda i: torch.from_numpy(np.concatenate([r[i] for r in rows])).to(dev)  # noqa: E731
        with torch.no_grad():
            boxes, logits, (score, idx) = seg.gdino(
                gdino_input(img.to(dev), seg.gdino_resize), cat(1), cat(2), cat(3), cat(4),
                top_idx=None if top_idx is None else top_idx.to(dev), return_selection=True)
            outs, protos = seg.sam(img.to(dev))
        cpu_ = lambda t: t.float().cpu()  # noqa: E731
        return ((cpu_(boxes), cpu_(logits)), (cpu_(score), idx.cpu()),
                ([{k: cpu_(v) for k, v in o.items()} for o in outs], cpu_(protos)))

    t0 = time.perf_counter()
    gd_c, sel_c, sam_c = run(cpu, image)
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    gd_g, sel_g, sam_g = run(gpu, image)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    differ = (sel_g[1] != sel_c[1])
    n_sel = int(differ.sum())
    if n_sel:
        # positions whose selection differs: their scores tie within the tolerance
        s_tol = GSAM_TOL * float(sel_c[0].abs().max())
        ranked_c = sel_c[0][0, sel_c[1][0]]
        ranked_g = sel_g[0][0, sel_g[1][0]]
        gap = float((ranked_c - ranked_g).abs().max())
        log(f"  two-stage selection: {n_sel} of {differ.numel()} positions differ, the "
            f"ranked scores by at most {gap:.3e} (tolerance {s_tol:.3e}); the card runs "
            "again on the CPU's selection")
        if not gap <= s_tol:
            raise AssertionError(f"query selection differs beyond ties: {gap:.3e}")
        gd_g, _, sam_g = run(gpu, image, top_idx=sel_c[1])
    rels = {}

    def rel(name, g, c):
        rels[name] = float((g - c).abs().max()) / max(float(c.abs().max()), 1e-12)

    rel("boxes", gd_g[0], gd_c[0])
    live = gd_c[1] > -1e29
    if not torch.equal(gd_g[1] > -1e29, live):
        raise AssertionError("token-logit masks differ")
    rel("token_logits", gd_g[1][live], gd_c[1][live])
    for i, (og, oc) in enumerate(zip(sam_g[0], sam_c[0])):
        for k in ("box", "cls", "mc"):
            rel(f"{k}{i}", og[k], oc[k])
    rel("protos", sam_g[1], sam_c[1])
    worst = max(rels, key=rels.get)
    log(f"  card vs CPU (cpu {t_cpu:.1f} s, card {t_gpu:.1f} s), relative to each output's "
        f"max abs: " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()))
    if not rels[worst] <= GSAM_TOL:
        raise AssertionError(f"Grounded-SAM {worst} differs by {rels[worst]:.3e} > {GSAM_TOL}")
    proposals = decode_predictions(*sam_c, cpu.sam_cfg)
    grounded = ground_nouns(gd_c[0][0].numpy(), gd_c[1][0].numpy(), rows[0][5],
                            cpu.box_threshold, cpu.text_threshold)
    probs = torch.sigmoid(gd_c[1][0][live[0]])
    log(f"  CPU run: {len(proposals[0]['boxes'])} FastSAM proposals kept, class "
        f"logits in [{min(float(o['cls'].min()) for o in sam_c[0]):.2f}, "
        f"{max(float(o['cls'].max()) for o in sam_c[0]):.2f}]; boxes grounded per noun "
        f"{ {GSAM_NOUNS[0][k]: len(v) for k, v in grounded.items()} }, live token "
        f"probabilities in [{float(probs.min()):.3f}, {float(probs.max()):.3f}]")
    masks = [cpu.decode_masks(rows, gd[0].numpy(), gd[1].numpy(),
                        decode_predictions(*sam, cpu.sam_cfg), 512, 512)
             for gd, sam in ((gd_c, sam_c), (gd_g, sam_g))]
    diff_px = sum(int((a != b).sum()) for ra, rb in zip(*masks) for a, b in zip(ra, rb))
    near = _gsam_near_threshold(cpu, rows, gd_c, sam_c, GSAM_TOL)
    log(f"  masks from the card's outputs against the CPU's: {diff_px} pixels differ of "
        f"{sum(m.size for r in masks[1] for m in r)}; mask coverage "
        f"{[float(m.mean()) for m in masks[1][0]]}; scores within the tolerance of "
        f"their thresholds: {near}")
    if diff_px and not sum(near.values()):
        raise AssertionError("masks differ with no score near its threshold")
    del cpu, gpu

    # the batched segmenter in bf16 at batch 4, as the trainer runs it
    seg = GroundedSAMSegmenter(device="cuda", sam_params=sam_sd, gdino_params=gd_sd,
                               gdino_resize=800)
    images = torch.rand(TRAIN_BATCH, 512, 512, 3, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 25))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        marks = {}

        def mark(name):
            torch.cuda.synchronize()
            marks[name] = time.perf_counter()

        t0 = time.perf_counter()
        out = seg.batch(images, GSAM_NOUNS, mark=mark)
        t_end = time.perf_counter()
        times.append((marks["segment_device"] - t0, t_end - marks["segment_device"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dev_s, host_s = sorted(times)[1]
    log(f"  batch of {TRAIN_BATCH} in bf16 (3 runs, the median's): device forwards "
        f"{dev_s:.3f} s, host decode {host_s:.3f} s (runs: "
        + ", ".join(f"{d:.3f} + {h:.3f}" for d, h in times)
        + f"); peak memory {peak:.2f} GiB; masks per image {[len(m) for m in out]}, "
        f"coverage {[round(float(np.mean(m)), 3) for r in out for m in r]}")
    if [len(m) for m in out] != [len(n) for n in GSAM_NOUNS] or not all(
            m.shape == (512, 512) for r in out for m in r):
        raise AssertionError(f"bad batched masks {[len(m) for m in out]}")
    del seg, images
    torch.cuda.empty_cache()
    return {"device_s": dev_s, "host_s": host_s, "peak_gib": peak}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from comat_tpu_torch.ops import _build
    from comat_tpu_torch.ops import conv3x3 as cv
    from comat_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(gpu_name_and_power())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    log("[1/10] build")
    t0 = time.perf_counter()
    paths = _build.build(["flash_fwd", "flash_bwd", "conv3x3", "conv3x3_dw"])
    log(f"  built {len(paths)} sources in {time.perf_counter() - t0:.1f} s")
    for path in paths.values():
        if os.path.exists(path + ".log"):
            for line in open(path + ".log"):
                if any(w in line for w in ("entry function", "registers", "spill",
                                           "warning")):
                    log("  " + line.strip())
    phase_sass(paths)
    kernels = [fa.KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL, cv.KERNEL, cv.DW_KERNEL]

    log("[2/10] kernels against their plain versions")
    t0 = time.perf_counter()
    entries = phase_kernels(torch, fa, cv)
    log(f"  {len(entries)} checks in {time.perf_counter() - t0:.1f} s")

    log("[3/10] generation: SD1.5 fp32 256^2 card vs CPU")
    phase_parity(torch, kernels)

    log("[4/10] full train step: SD1.5 + BLIP-large + D fp32 256^2 card vs CPU")
    tune_vae_shapes = phase_train_parity(torch, fa, cv, kernels)

    log("[5/10] generation main path: SD1.5 512^2 bf16, 2 prompts, 50 DDPM steps")
    gen_shapes = phase_main(torch, kernels)

    log("[6/10] train main path: SD1.5 + BLIP-large 512^2, 4 prompts, 50 steps, K 5")
    train_shapes, _, (pipe, blip, batch) = phase_train_main(torch, fa, cv, kernels)

    log("[7/10] train with the VAE trained: the recipe, bf16 decoder, fp32 masters")
    tune_bf16_shapes, _, _ = phase_train_tune_vae(torch, fa, cv, kernels, pipe, blip, batch)

    log("[8/10] full recipe: + GAN (D LoRA 128) + attribute concentration, A 2")
    full_shapes, full_median, full_peak = phase_train_full(torch, fa, cv, kernels, pipe,
                                                           blip, batch)
    del pipe, blip, batch

    log("[9/10] trainer CLI: comat_tpu_torch/scripts/sd15.sh's flags (Grounded-SAM), "
        f"512^2, batch 4, {CLI_STEPS} steps, then a run resumed at step {CLI_RESUME}")
    cli_shapes, encode_shapes = phase_trainer_cli(torch, fa, cv, kernels, full_median,
                                                  full_peak)

    log("[10/10] Grounded-SAM: GroundingDINO-T 800^2 + FastSAM-x 512^2 fp32 card vs CPU, "
        "then bf16 at batch 4")
    phase_gsam(torch)

    # launches: those of the driven paths, each counted from 0 just before
    # it: generation, the reduced recipe's train step, the same with the
    # VAE trained (bf16), dw in the fp32 train step with the VAE trained
    # (phase 4's card run), the full recipe's step, the latent store's
    # encoding and the trainer CLI's two runs
    paths = {"generate": gen_shapes, "train": train_shapes,
             "train_tune_vae_bf16": tune_bf16_shapes,
             "train_tune_vae": {cv.DW_KERNEL.symbol: tune_vae_shapes[cv.DW_KERNEL.symbol]},
             "train_full": full_shapes, "gan_store_encode": encode_shapes,
             "trainer_cli": cli_shapes}
    for e in entries:
        key = tuple(e.pop("key"))
        for path, shapes in paths.items():
            e[f"launches_{path}"] = shapes.get(e["kernel"], {}).get(key, 0)
        e["launches"] = sum(e[f"launches_{path}"] for path in paths)
    measured = {(e["kernel"], tuple(e["shape"]), e["dtype"]) for e in entries}
    for path in paths.values():
        for symbol, counts in path.items():
            # a conv launch key ends in its role ("fwd" or "dx")
            strip = 2 if symbol == cv.KERNEL.symbol else 1
            missing = {k: n for k, n in counts.items()
                       if (symbol, k[:-strip], k[-strip]) not in measured}
            if missing:
                raise AssertionError(f"{symbol}: main-path shapes not measured: {missing}")
    # each kernel's share of the main paths, from its per-shape times above
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "conv3x3_fwd", "conv3x3_dx", "conv3x3_dw"):
        for path in paths:
            sel = [e for e in entries if e["name"] == name and e[f"launches_{path}"]]
            if not sel:
                continue
            n = sum(e[f"launches_{path}"] for e in sel)
            total_ms = {key: sum(e[f"launches_{path}"] * e[key] for e in sel)
                        for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
            log(f"  {name} on the {path} path: {n} launches x ms = "
                f"{total_ms['ms']:.1f} ms (plain {total_ms['plain_ms']:.1f}, "
                f"library {total_ms['library_ms']:.1f}, bound {total_ms['bound_ms']:.2f})")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    # "kernels": the shapes the driven paths launched; "checks": the other
    # comparisons (fp32, ragged keys), with the same keys
    print(json.dumps({
        "kernels": [e for e in entries if e["launches"] > 0],
        "checks": [e for e in entries if e["launches"] == 0],
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
