#!/usr/bin/env python3
"""Smoke run of the PyTorch port (comat_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure ends the run with a nonzero exit and no result line:
1. build: print the card's name and power limit, build every CUDA kernel
   (one nvcc per source, all six at once), print what ptxas reports for
   each kernel (registers, spills), and count the tensor-core
   instructions (HGMMA, HMMA, IMMA) of each kernel in the built SASS
   (`cuobjdump -sass`); fail if the bf16 code of the flash forward (A),
   of its dq or dk/dv backward, of the 3x3 conv (B) or of its dw, or the
   int8 conv, has none;
2. kernels: each kernel against its plain PyTorch version at the shapes
   the two main paths give it, in fp32 (TF32 off) and bf16, with its time,
   the plain version's, one PyTorch library call's, and its bound: the
   flash-attention forward, its dq and dk/dv backward kernels, the 3x3
   conv forward, its dx (the forward kernel through the autograd Function,
   against the plain vjp) and its dw (also at the shapes phase 4 gives
   it, where the train step runs it); and SDXL's (phases 11 and 12): the
   flash forward, dq and dk/dv at d = 64, (12, 10, 1024, 1024, 64) and
   (12, 20, 256, 256, 64) and the capture's batch 6, the SD1.5 D at batch
   6 and 12, the VAE's attention at batch 6, the decoder's convs and dx
   and the encoder's convs at batch 6;
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
   full width, 512^2, bf16, 2 prompts, 50 DDPM steps, CFG 7.5, weights
   seeded with the launcher's seed (42), the hash tokenizer at vocab
   49408; finite (2, 512, 512, 3) images and the expected kernel launch
   counts;
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
   beside phase 8's; its step 1's trained tensors and its seeded towers
   are kept for phase 13;
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
11. SDXL parity: SDXL at full width (UNet (320, 640, 1280), CLIP-L and
   OpenCLIP bigG, the VAE at 0.13025) in fp32 with seeded weights, on the
   card and on the CPU: `encode_prompt` through both towers (the second
   tokenizer padding with id 0), one guided UNet call at 512^2, batch 1
   (CFG 7.5, the added condition; the UNet on the CPU's encodings), the
   decode of one latent; each output within 1e-3 of its max abs, and the
   card's launches (70 A, then 1 A and 21 B);
12. the SDXL trainer CLI: `comat_tpu_torch.train.main` with the flags of
   comat_tpu_torch/scripts/sdxl.sh (the repo's scripts/sdxl.sh plus
   --allow_smoke: sdxl_attrcon_unet, 512^2, batch 6, total_step 50, K 5,
   CFG 7.5, LoRA 128, --gradient_checkpointing, the GAN with an
   SD1.5-architecture D of its own, Grounded-SAM at A 2) for 2 steps, with
   a checkpoint at step 0 and 2, against a GanLatentStore the SDXL VAE
   encoder made from 6 seeded images; seconds per step and its split,
   peak memory, the launches by role against those the config predicts.
13. snapshots: synthetic snapshots in the HF hub cache's layout, written
   under a temporary folder in build/chip_smoke/ and deleted at the end:
   SD1.5 (phase 9's seeded towers, which phase 5 generated with, in fp32
   as the SD1.5 repository ships them, the proj_in/proj_out 1x1 convs, the
   VAE's mid-block attention under older diffusers' names, the text
   encoder's position_ids) as runwayml/stable-diffusion-v1-5 and
   BLIP-large (phase 9's seeded captioner, the tied LM head dropped) as
   Salesforce/blip-image-captioning-large. The generator
   (`tools/generate.main --pretrain-model` with --cache-dir) on phase 5's
   prompts, seed and draws makes phase 5's image bit for bit, with its
   launches; the trainer on the launcher's flags with --cache_dir (its
   default ids resolve there) runs 2 steps: every tower and the captioner
   equal phase 9's seeded ones, no tensor missing or unused, no smoke
   fallback for weights, step 1's loss and every G and D trained tensor
   after it equal phase 9's step 1 bit for bit, its launches by role
   phase 9's a step. Then SDXL's fp16 variant files (seeded) load into a
   fresh SDXL pipeline: every tensor the fp16 value rounded once, none
   missing. The seconds and GB/s of each load, file read and copy to the
   card apart, and the host RSS's peak during the SDXL load.
14. the latent store and accumulation: `tools.gan_gt_generate.main` on the
   first 8 prompts of merged_data/abc5k_hrs10k_t2icompall_20k.txt at
   512^2 (SD1.5 seeded with the launcher's seed, batch 4, 50 DDPM steps,
   no decode: 1500 A and no B), read back by `GanLatentStore`, and again
   with --use-cache (nothing generated); then the trainer on sd15.sh's
   flags over those prompts and that store (no smoke fallback of kind
   "data") with --gradient_accumulation_steps 2 for 4 micro-steps: the
   LoRA factors unchanged after micro-steps 1 and 3 and all changed after
   2 and 4, D's tensors all changed every micro-step, the launches by role
   phase 9's a micro-step; a run resumed from checkpoint-3 ends micro-step
   4 bit for bit (the running mean included). The store's seconds a batch,
   the seconds of micro-steps and applying steps apart, the peak memory;
15. the evaluator: BLIP-VQA at base width (ViT-B/16) in fp32, seeded, card
   against CPU on 2 images x 3 questions, both answer log-likelihoods and
   P(yes) within 1e-3 of each one's max abs; then `tools.evaluate.main`
   at 512^2 on 4 prompts of the same corpus with a colour word, one batch,
   --metric both --allow-smoke: a row a prompt, every P(yes) in [0, 1], a
   finite reward, 751 A and 21 B; generation, decode, reward and BLIP-VQA
   seconds apart.
16. SD1.5 trainable surfaces: (a) phase 4's geometry in fp32 (256^2,
   total_step 4, K 2, 1 prompt, SD1.5 and BLIP-large at full width, the
   BLIP reward) with --full_finetuning (the whole UNet and its LoRA 128),
   CLIP-L whole (--tune_text_encoder) and LoRA 8 on its attention
   (--train_text_encoder_lora), nonzero lora_b, card against CPU: the
   loss and its components within 1e-3, every UNet, text-LoRA and CLIP-L
   gradient leaf within 1e-3 relative (the zero-leaf rule of phase 4);
   (b) the trainer CLI on sd15.sh's flags plus --full_finetuning
   --use_8bit_adam --train_text_encoder_lora --tune_text_encoder, 3 steps
   with a validation image and a checkpoint at 0, 2 and 3 (the newest two
   kept), against phase
   9's latent store: seconds per step and its split, s_optimizer, peak
   memory, the 8-bit state's bytes, launches by role phase 9's a step;
   (c) D's base (a frozen copy under --full_finetuning) equals its initial
   values with no gradient after 3 G updates while G's base moved; the
   exported file loads into a fresh pipeline with no tensor missing or
   unused; a run resumed from checkpoint-2 ends step 3 bit for bit, the
   8-bit codes and scales included. Its outputs are deleted at the end.
17. SDXL trainable surfaces: the trainer on sdxl.sh's flags plus the same
   four flags, 2 steps (`Trainer.train_one`, no checkpoint) at batch 6,
   or the largest of 4 and 2 that fits, against phase 12's latent store:
   text2.text_projection's gradient (it comes through the pooled embeds)
   finite and nonzero after step 1, every fp32 master moved by step 1
   (but the zero tensors no gradient reaches: CLIP-L's last layer, unread
   by SDXL), seconds per step, s_optimizer, peak memory, launches by role
   phase 12's a step.
18. the int8 kernels of --pass1_int8 (csrc/quant_s8.cu, csrc/conv_s8.cu;
   no Pallas counterpart, XLA in JAX): at every distinct quantized layer
   of SD1.5 at 512^2 (CFG batch 8) and SDXL (CFG batch 12), on the layer's
   real input from one guided call of the seeded bf16 pipelines and its
   weight, the quantize's codes and scales (activations and weights), the
   int8 conv's int32 sums and bf16 epilogue and the dequantize after
   `torch._int_mm`, each equal to its plain version bit for bit; times
   against the plain versions, cuDNN's bf16 conv or `F.linear`, and
   `torch._int_mm` with a plain dequantize (and the conv kernel as a 1x1
   conv over a linear's rows);
19. W8A8 pass 1: 50 guided calls through the fused twin, bf16 and int8
   from the same draws in turns, SD1.5 at batch 4 and SDXL at batch 6:
   seconds, the weight set's bytes and quantize seconds, cos of the final
   latents > 0.99 (JAX's gate), int8 launches per layer; then the trainer
   on sd15.sh's flags with --pass1_int8 for 2 steps (`train_one`): s_step
   and its split beside phase 9's, peak memory, launches by role (every
   int8 launch in pass 1's), step 1's loss beside phase 9's bf16 step 1
   from the same draws;
20. v-prediction: phase 4 with --prediction_type v_prediction (the same
   gates), then again with --pass1_int8, the card running the step and
   the CPU pass 1 and its decode (every int8 call of the step): the
   activation codes that differ between card and CPU are counted; up
   to the first quantize call whose codes differ the two sides' inputs
   agree to fp32 roundoff, and there every differing code sits within
   that roundoff of a .5 boundary of the code grid (gated);
21. stability: `tools/stability_run.py` for 6 steps (bench's default
   SD1.5 step at batch 4): each step's seconds, their spread, all finite;
22. data parallelism (`parallel/mesh.py`): (a) the trainer on sd15.sh's
   flags (phase 9's argv) for 2 steps under a world-1 NCCL group: each
   step's loss and every G and D trained tensor after step 2 equal phase
   9's first two steps, run without a group, bit for bit; s_allreduce and
   the bytes all-reduced a step printed; launches by role as phase 9's;
   (b) two spawned processes on this one card joined by Gloo, each the
   trainer at batch 2 for one step, against one process at batch 4 from
   the same seed, both with the CenterPrior segmenter (Grounded-SAM's
   masks move with bf16 roundoff in the image): the global loss within
   1e-3 relative, each LoRA leaf's all-reduced gradient at cos >= 0.999
   and its norm within 1 %, the two ranks' gradients and tensors equal,
   their rows the one process's batch; each rank's peak and seconds
   printed (two processes sharing one card: not a scaling figure);
23. tensor parallelism (`parallel/tp.py`): two spawned ranks over Gloo
   shard SD1.5's UNet at full width (fp32, TF32 off, LoRA 128) with
   `apply_tp`; one guided call (batch 2, 512^2) and the LoRA backward of a
   fixed weighting of eps against the unsharded UNet on the same inputs:
   eps and every LoRA gradient at cos >= 0.9999 and max relative error <=
   1e-2; kernel A launches at 4 heads where the unsharded call launches
   at 8; then W8A8 on the tensor-parallel UNet: SD1.5's LoRA-free UNet
   (the fused pass 1's) in bf16, `apply_tp` then `quantize_unet` on each
   rank, one guided call (batch 2, 512^2) under the int8 weight set
   against the unsharded int8 UNet: the weight codes and scales (each
   rank's slice), every activation's scales and codes (a row-parallel
   layer's input: its slice) and eps equal bit for bit; the quantize
   kernel's launches on each rank, two a row-parallel quantize (the
   absmax, then the codes after the MAX all-reduce);
24. the native host runtime (`native_host.py`, `csrc/comat_host.cpp`):
   (a) a g++ build of the host library from scratch, its seconds; (b) a
   byte-level vocabulary written here (the 256 byte symbols, their </w>
   forms, merges learned from the corpus): `NativeCLIPTokenizer` and
   `CLIPBPETokenizer` give the same ids and EOS positions on every line
   of merged_data/abc5k_hrs10k_t2icompall_20k.txt (its 4 non-ASCII
   lines among them), each one's seconds; (c) phase 14's store plus a
   second latent for some prompts and one NCHW file: `NativeLatentStore`
   and `GanLatentStore` from one seed give identical arrays over one
   prompt sequence, the seconds a batch of 4 takes in each; (d) the
   trainer on phase 9's flags plus --tokenizer_dir (that vocabulary) and
   --gan_gt_path (that store) over phase 14's prompts for 3 steps, which
   holds the native pieces, then the same trainer built again with its
   `clip_tok` and `latent_store` swapped for the Python pieces: each
   step's loss and every G and D tensor after equal bit for bit, the
   launches by role equal and phase 9's.
Each phase prints the GiB allocated and reserved at its start. Then one
JSON line {"kernels": [...], "checks": [...]} and, last, the
device line. A kernel entry's `launches` counts the launches at its shape
in the driven paths: generation, the reduced recipe's train step, the
same step with the VAE trained, phase 4's fp32 card run of the train step
with the VAE trained (dw), the full recipe's step, the latent store's
encoding, the trainer CLI's run, SDXL's latent store and trainer run,
the generation and trainer run from the SD1.5 snapshot, the latent tool's
store, the accumulated trainer's runs, the evaluator, phases 16(b) and
17's trainers, phase 19's pass 1 (int8) and trainer, phase 21's steps,
phase 22(a)'s trainer and phase 24(d)'s trainer on the native pieces
(22(b) and 23 run in processes of their own, whose launches are checked
there). The trainers over a store of .npy files (phase 9's and after)
read it through `NativeLatentStore`. Weights are random (the real ones are not in the
repository); depth is not cut.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}   # H100 SXM, dense
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
# SDXL (phases 11 and 12): at 512^2 the UNet runs 70 self-attentions over
# more than 128 keys a call, all at d = 64: 10 at S = 1024 (640 wide, 10
# heads) and 60 at S = 256 (1280 wide, 20 heads). (B, H, Sq, Skv, d):
# pass 1 and the replay at CFG batch 12, the capture forwards at batch 6
SDXL_ATTN = 70
SDXL_BATCH = 6
SDXL_FLASH = [(12, 10, 1024, 1024, 64), (12, 20, 256, 256, 64),
              (6, 10, 1024, 1024, 64), (6, 20, 256, 256, 64)]
# the SDXL recipe's SD1.5-architecture D at batch 6 (G loss) and 12 (its
# update), and the VAE's mid-block attention at batch 6 (decode, encode)
SDXL_D_FLASH = [(6, 8, 4096, 4096, 40), (6, 8, 1024, 1024, 80), (6, 8, 256, 256, 160),
                (12, 8, 4096, 4096, 40), (12, 8, 1024, 1024, 80), (12, 8, 256, 256, 160)]
SDXL_VAE_FLASH = (6, 1, 4096, 4096, 512)
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
# the SDXL trainer (phase 12): comat_tpu_torch/scripts/sdxl.sh's flags at
# batch 6 (CFG 12), 3 steps; per step by role, SDXL_ATTN A a UNet call:
# pass 1's 50 guided calls in the presample; the replay's 5 segments each
# run the UNet forward inside their backward and, under remat, every
# checkpointed block's forward again, then its backward; the 2 capture
# forwards (batch 6) and their recompute, not checkpointed; the decode as
# phase 9's; the SD1.5-architecture D as phase 8's (15 A a call)
SDXL_LAUNCHER = os.path.join("comat_tpu_torch", "scripts", "sdxl.sh")
SDXL_STEPS = 2
SDXL_CLI_LAUNCHES = {
    "pass1": {"flash_fwd": 50 * SDXL_ATTN},
    "presample": {"flash_fwd": 1, "conv_fwd": 21},
    "replay": {"flash_fwd": 5 * 2 * SDXL_ATTN, "dq": 5 * SDXL_ATTN, "dkv": 5 * SDXL_ATTN},
    "capture": {"flash_fwd": 2 * 2 * SDXL_ATTN, "dq": 2 * SDXL_ATTN, "dkv": 2 * SDXL_ATTN},
    "decode": {"flash_fwd": 1, "dq": 1, "dkv": 1, "conv_fwd": 39, "conv_dx": 21},
    "d_forward": {"flash_fwd": 30},
    "d_backward": {"dq": 30, "dkv": 30},
}
SDXL_PARITY_TOL = 1e-3   # relative to each output's max abs
# comat_tpu_torch/scripts/sd15.sh's --seed: phase 5 generates with it, so
# that the towers phase 9's trainer seeds are phase 5's weights too
TRAINER_SEED = 42
# phase 13: synthetic snapshots in the HF hub cache's layout, under the
# ids the launchers and the trainer name
SD15_ID = "runwayml/stable-diffusion-v1-5"
SDXL_ID = "stabilityai/stable-diffusion-xl-base-1.0"
CAPTION_ID = "Salesforce/blip-image-captioning-large"
SNAPSHOT_STEPS = 2
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
# phase 20 with --pass1_int8: the activation quantize calls whose inputs
# are kept on both sides, and the relative gap (max |card - CPU| over max
# |CPU|) within which the inputs agree up to the first differing code
WITNESS_CALLS = 64
WITNESS_REL = 1e-4


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
# 3x3 conv (B) and of its dw, and the int8 conv (IMMA)
TENSOR_CORE_KERNELS = ("flash_fwd_bf16_kernel", "flash_bwd_dq_bf16_kernel",
                       "flash_bwd_dkv_bf16_kernel", "conv3x3_bf16_kernel",
                       "conv3x3_dw_bf16_kernel", "conv_s8_kernel")


def sass_tensor_core_counts(lib_path: str) -> dict:
    """{kernel function: (HGMMA count, HMMA or IMMA count)} in a built
    library's SASS, read with cuobjdump from the toolkit that built it."""
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
        elif name is not None and ("HMMA" in line or "IMMA" in line):
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
            log(f"  {source}: {fn}: {hgmma} HGMMA, {hmma} HMMA/IMMA")
        if others[0]:
            log(f"  {source}: {others[0]} other kernels: {others[1]} HGMMA, "
                f"{others[2]} HMMA")
    for kernel in TENSOR_CORE_KERNELS:
        if not found.get(kernel) or min(found[kernel]) == 0:
            raise AssertionError(f"{kernel}: no tensor-core instructions in "
                                 f"its SASS ({found.get(kernel)})")
    return found


def time_ms(torch, fn, budget_ms: float = 300.0) -> float:
    """Mean ms per call on the card (CUDA events), after one warm-up: over
    as many calls as fill `budget_ms` (1-50)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(1, min(50, int(budget_ms / max(start.elapsed_time(end), 1e-3))))
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
           nbytes, library, ops_dtype=None, **extra):
    """A kernels-line entry; the bound counts `flops` at the peak of
    `ops_dtype` (default `dtype`)."""
    ms, plain, lib = times
    bms, by = bound_ms(flops, nbytes, ops_dtype or dtype)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                shape=list(shape), dtype=dtype, kernel=kernel, key=key,
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib, library=library, **extra)


def _log_entry(e) -> None:
    lib_err = (f", its err {e['library_max_abs_err']:.2e}"
               if "library_max_abs_err" in e else "")
    lib = ("no library call" if e["library_ms"] is None
           else f"{e['library']} {e['library_ms']:.3f}{lib_err}")
    extra = "".join(f", {k} {e[k]:.3f}" for k in ("int_mm_ms", "conv_s8_1x1_ms",
                                                   "linear_bf16_ms", "gemm_bound_ms") if k in e)
    log(f"  {e['name']} {e['dtype']} {e['shape']}: err {e['max_abs_err']:.2e}, "
        f"{e['ms']:.3f} ms (plain {e['plain_ms']:.3f}, {lib}, bound {e['bound_ms']:.3f} "
        f"by {e['bound_by']}{extra})")


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
    # SDXL (phases 11 and 12): its UNet's d = 64 and the SD1.5 D at batch 6
    # in fp32 and bf16; in bf16 too D's update at batch 12, the VAE's
    # attention and its convs (decode forward and dx, encode) at batch 6
    for dtype, shapes in (("float32", SDXL_FLASH[:2] + SDXL_D_FLASH[:3]),
                          ("bfloat16", SDXL_FLASH + SDXL_D_FLASH + [SDXL_VAE_FLASH])):
        for shape in shapes:
            entries += check_flash_fwd(torch, fa, gen, shape, dtype)
            _log_entry(entries[-1])
            entries += check_flash_bwd(torch, fa, gen, shape, dtype)
            _log_entry(entries[-2])
            _log_entry(entries[-1])
            torch.cuda.empty_cache()
    for Hs, C, Cout in DECODER_CONVS:
        entries += check_conv_fwd(torch, cv, gen, SDXL_BATCH, Hs, C, Cout, "bfloat16")
        _log_entry(entries[-1])
        entries += check_conv_dx(torch, cv, gen, SDXL_BATCH, Hs, C, Cout, "bfloat16")
        _log_entry(entries[-1])
        torch.cuda.empty_cache()
    for Hs, C, Cout in ENCODER_CONVS:
        entries += check_conv_fwd(torch, cv, gen, SDXL_BATCH, Hs, C, Cout, "bfloat16")
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
    f32 = lambda c: c and dataclasses.replace(c, dtype=torch.float32)  # noqa: E731
    return dataclasses.replace(
        cfg, unet=f32(cfg.unet), text=f32(cfg.text), vae=f32(cfg.vae),
        text2=f32(cfg.text2),
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
    # drawn on the card, copied to the CPU: the CPU's draws take seconds
    gpu = DiffusionPipeline(cfg, device="cuda", seed=SEED)
    cpu = DiffusionPipeline(cfg, device="cpu", params=gpu.state_dicts())
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


def _first_flip_at_a_boundary(torch, differ, calls, inputs) -> None:
    """Phase 20's witness that card and CPU part through fp32 roundoff at a
    code boundary and not through a fault: up to the first activation
    quantize call whose codes differ, the two sides' inputs agree within
    WITNESS_REL, and there each differing code's CPU value x / s lies
    within the two sides' own gap |x / s (card) - x / s (CPU)| of a .5
    boundary, and that gap is at most 127 * 2 * WITNESS_REL code units."""
    first = next((i for i, n in enumerate(differ) if n), None)
    if first is None:
        log("  int8 witness: no activation code differs between card and CPU")
        return
    if first >= len(inputs["cpu"]):
        raise AssertionError(f"int8 witness: the first differing codes are in quantize call "
                             f"{first}, past the {WITNESS_CALLS} kept")
    gaps = []
    for (xc, _), (xg, _) in zip(inputs["cpu"][:first + 1], inputs["cuda"][:first + 1]):
        gaps.append(float((xg - xc).abs().max() / xc.abs().max().clamp_min(1e-30)))
    (xc, sc), (xg, sg) = inputs["cpu"][first], inputs["cuda"][first]
    groups = sc.numel()
    r_cpu = xc.double().reshape(groups, -1) / sc.double()[:, None]
    r_gpu = xg.double().reshape(groups, -1) / sg.double()[:, None]
    mask = (calls[first][0] != calls[first][1]).reshape(groups, -1)
    a = r_cpu.abs()
    off = (a - a.floor() - 0.5).abs()[mask]
    gap = (r_gpu - r_cpu).abs()[mask]
    log(f"  int8 witness: the first differing codes are in quantize call {first}, "
        f"{int(mask.sum())} of {mask.numel()}; inputs card vs CPU up to there within "
        f"{max(gaps):.3e} relative (calls: {[f'{g:.1e}' for g in gaps]}); the differing "
        f"codes' CPU values lie {float(off.max()):.3e} code units at most from a .5 "
        f"boundary, their card-CPU gap {float(gap.max()):.3e} at most")
    if not (max(gaps) <= WITNESS_REL and bool((off <= gap + 1e-12).all())
            and float(gap.max()) <= 2 * 127 * WITNESS_REL):
        raise AssertionError(f"int8 witness: codes part at call {first} beyond fp32 roundoff: "
                             f"input gaps {gaps}, boundary offsets {off.tolist()[:8]}, "
                             f"card-CPU gaps {gap.tolist()[:8]}")


def phase_train_parity(torch, fa, cv, kernels, prediction_type="epsilon", oq=None):
    """One make_loss_fn value and backward, then D's loss and backward at
    its latents (what the step's D update differentiates), on the card and
    on the CPU. `prediction_type` (phase 20: "v_prediction"); with `oq`
    (ops.quant) pass 1 runs W8A8 (--pass1_int8) and the activation codes of
    the two sides are compared: the fp32 roundoff of the card and the CPU
    puts some on either side of a code boundary, after which the int8
    trajectories part, so nothing after the codes is compared, and the
    CPU runs only what holds every int8 call of the step, pass 1 and its
    decode (`make_presample`: the split step's pass 1, which the unsplit
    step's equals bit for bit); the card runs the whole step."""
    from comat_tpu_torch.config import BLIPConfig
    from comat_tpu_torch.diffusion.schedulers import inference_timesteps
    from comat_tpu_torch.losses.gan import Discriminator, GanConfig, gan_d_loss
    from comat_tpu_torch.models.blip import make_blip
    from comat_tpu_torch.models.pipeline import DiffusionPipeline
    from comat_tpu_torch.training import train_step as ts
    from comat_tpu_torch.training.attrcon import make_attrcon_extra_losses

    cfg = dataclasses.replace(fp32_config("sd_1_5_attrcon", 256, lora_rank=128),
                              capture_layers=PARITY_CAPTURE, prediction_type=prediction_type)
    bcfg = dataclasses.replace(BLIPConfig.large(), dtype=torch.float32)
    tcfg = ts.TrainConfig(total_step=4, K=2, resolution=256, gan_loss=True, attrcon=True,
                          pass1_int8=oq is not None)
    codes = {"cpu": [], "cuda": []}
    inputs = {"cpu": [], "cuda": []}     # (x, scales) of the first WITNESS_CALLS
    if oq is not None:
        quantize = oq.quantize

        def recording(x, groups, role="act"):
            q, sc = quantize(x, groups, role)
            if role == "act":
                side = x.device.type
                codes[side].append(q.cpu())
                if len(inputs[side]) < WITNESS_CALLS:
                    inputs[side].append((x.float().cpu(), sc.cpu()))
            return q, sc

        oq.quantize = recording
    gan_cfg = GanConfig(lora_rank=128)
    t0 = time.perf_counter()
    # drawn on the card, copied to the CPU: the CPU's draws take seconds
    gpu = DiffusionPipeline(cfg, device="cuda", seed=SEED)
    g = torch.Generator().manual_seed(SEED + 11)
    _nonzero_lora_b(torch, gpu.unet, g)
    d_gpu = Discriminator(cfg.unet, gan_cfg, device="cuda", base_unet=gpu.unet, seed=SEED + 7)
    _nonzero_lora_b(torch, d_gpu, g)
    cpu = DiffusionPipeline(cfg, device="cpu", params=gpu.state_dicts())
    d_cpu = Discriminator(cfg.unet, gan_cfg, device="cpu", base_unet=cpu.unet)
    d_cpu.load_state_dict(_d_own(d_gpu), strict=False)
    blip_gpu = make_blip(bcfg, device="cuda", seed=SEED + 1)
    blip_cpu = make_blip(bcfg, device="cpu", params=blip_gpu.state_dict())
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
    try:
        if oq is None:
            metrics_cpu, grads_cpu = run(cpu, blip_cpu, d_cpu)
        else:
            with torch.no_grad():
                ts.make_presample(cpu, tcfg)(batch, draws)
        t_cpu = time.perf_counter() - t0
        del cpu, blip_cpu, d_cpu
        reset(kernels)
        t0 = time.perf_counter()
        metrics_gpu, grads_gpu = run(gpu, blip_gpu, d_gpu)
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
    finally:
        if oq is not None:
            oq.quantize = quantize
    counts = counts_by_role(fa, cv)
    by_shape = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
    want_keys = {"step_loss", "reward_blip", "G_loss", "token_loss", "pixel_loss", "D_loss"}
    if not want_keys <= set(metrics_gpu):
        raise AssertionError(f"train parity metrics lack {want_keys - set(metrics_gpu)}")
    if oq is not None:
        calls = list(zip(codes["cpu"], codes["cuda"]))
        differ = [int((a != b).sum()) for a, b in calls]
        total = sum(a.numel() for a, _ in calls)
        per_call = len(calls) // tcfg.total_step
        first = sum(differ[:per_call])
        log(f"  card {metrics_gpu} (CPU: pass 1 and its decode in {t_cpu:.1f} s; card: the "
            f"step in {t_gpu:.1f} s)")
        log(f"  int8 activation codes card vs CPU: {sum(differ)} of {total} differ "
            f"({sum(differ) / max(total, 1):.3e}) over {len(calls)} quantize calls "
            f"({len(codes['cpu'])} on the CPU); in pass 1's first UNet call {first} of "
            f"{sum(a.numel() for a, _ in calls[:per_call])}, in its first layers "
            f"{differ[:8]} of {[a.numel() for a, _ in calls[:8]]}")
        log(f"  launches {counts}")
        if len(codes["cpu"]) != len(codes["cuda"]) or not calls or not all(
                math.isfinite(metrics_gpu[k]) for k in want_keys):
            raise AssertionError(f"int8 parity: {len(codes['cpu'])} / {len(codes['cuda'])} "
                                 f"quantize calls, metrics {metrics_gpu}")
        _first_flip_at_a_boundary(torch, differ, calls, inputs)
        if counts != PARITY_TRAIN_LAUNCHES:
            raise AssertionError(f"train parity launched {counts}, "
                                 f"expected {PARITY_TRAIN_LAUNCHES}")
        del gpu, blip_gpu, d_gpu
        torch.cuda.empty_cache()
        return by_shape
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
    """Returns (launches by kernel and shape, the images on the host, the
    generator's argv)."""
    from comat_tpu_torch.tools.generate import main as generate_main

    out_dir = os.path.join(REPO, "build", "chip_smoke")   # PNGs; build/ is ignored
    argv = [
        "--model", "sd_1_5", "--resolution", "512",
        "--num-inference-steps", "50", "--guidance-scale", "7.5",
        "--scheduler", "ddpm", "--seed", str(TRAINER_SEED), "--device", "cuda",
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
    return by_shape, images.cpu(), argv


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


def encode_latent_store(torch, fa, cv, kernels, out_dir, prompts_path, sdxl=False,
                        batch=TRAIN_BATCH):
    """The GAN's latent store for phase 9 (12 with `sdxl`): the SD1.5 (SDXL)
    VAE encoder (bf16, seeded weights) encodes `batch` seeded 512^2 images
    on the card; their means times the scaling factor are written as (64,
    64, 4) .npy files and indexed (jsonl) for every training prompt, round
    robin. Returns (index path, launches by kernel and shape)."""
    from comat_tpu_torch.config import VAEConfig
    from comat_tpu_torch.models.vae import AutoencoderKL
    from comat_tpu_torch.training.data import load_prompts
    from comat_tpu_torch.weights import init_weights_

    cfg = VAEConfig.sdxl() if sdxl else VAEConfig.sd15()
    with torch.device("meta"):
        vae = AutoencoderKL(cfg)
    vae = vae.to_empty(device="cuda").eval().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    init_weights_(vae, gen)
    images = torch.rand(batch, 512, 512, 3, generator=gen, device="cuda") * 2 - 1
    reset(kernels)
    with torch.no_grad():
        mean, logvar = vae.encode(images)
    torch.cuda.synchronize()
    counts = {k: n for k, n in counts_by_role(fa, cv).items() if n}
    by_shape = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
    latents = (mean * cfg.scaling_factor).float().cpu().numpy()
    log(f"  encoded {batch} images to {latents.shape}, latent std "
        f"{latents.std():.4f} (scaling {cfg.scaling_factor}); launches {counts}")
    if latents.shape != (batch, 64, 64, 4) or not (
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
            f.write(json.dumps({"prompt": p, "file_path": f"latent_{j % batch}.npy"})
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


def record_grads(optimizer, out: dict) -> None:
    """Wrap `optimizer.step` so that its first call leaves G's gradients,
    after any all-reduce and before the clip, in `out` (fp32 numpy by
    name)."""
    inner = optimizer.step

    def step(reduce=None, norm=None):
        def seen(grads):
            if reduce is not None:
                reduce(grads)
            if not out:
                out.update({n: m.grad.detach().float().cpu().numpy()
                            for n, m in optimizer.masters.items()})
        return inner(seen, norm)

    optimizer.step = step


def record_first_step(trainer, steps: int = 1) -> dict:
    """Wrap the trainer's step so that its first call leaves the step loss
    and every G and D trainable tensor after it (on the host) in the dict
    returned, and its first `steps` calls the same in its list "steps"."""
    step1, inner = {"steps": []}, trainer.train_step

    def step(state, batch, **kw):
        state, metrics = inner(state, batch, **kw)
        if len(step1["steps"]) < steps:
            step1["steps"].append({
                "loss": metrics["step_loss"],
                "g": {n: p.detach().cpu() for n, p in state.trainable.items()},
                "d": {n: p.detach().cpu() for n, p in trainer.d_state.trainable.items()}})
            if len(step1["steps"]) == 1:
                step1.update(step1["steps"][0])
        return state, metrics

    trainer.train_step = step
    return step1


def phase_trainer_cli(torch, fa, cv, kernels, full_median, full_peak):
    """The trainer CLI with scripts/sd15.sh's flags at 512^2, then a resume
    from its checkpoint. Returns (launches by kernel and shape of the
    trainer's runs, of the latent store's encoding, the first run's
    medians, its peak memory GiB, and for phase 13: its argv, the latent
    store's index, step 1's loss and trained tensors, the seeded towers
    and captioner on the host)."""
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
    held = torch.cuda.memory_allocated() / 2 ** 30    # by earlier phases
    reset(kernels)
    t0 = time.perf_counter()
    trainer = Trainer(parse_args(argv_first), probe=probe)
    step1 = record_first_step(trainer, DDP_STEPS)
    trainer.train()
    trainer.metrics.close()
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
        f"segments sum to {seg_sum:.3f} s), peak memory {peak:.1f} GiB ({peak - held:.2f} "
        f"above the {held:.2f} GiB held before the trainer), "
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
    # the seeded towers (never trained: the run trains LoRA factors), for
    # phase 13's snapshots
    seeded = {tower: {n: v.detach().cpu().clone() for n, v in module.state_dict().items()
                      if "lora_" not in n}
              for tower, module in (("unet", trainer.pipeline.unet),
                                    ("text", trainer.pipeline.text),
                                    ("vae", trainer.pipeline.vae), ("blip", trainer.blip))}
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
    return cli_shapes, encode_shapes, median, peak, {
        "argv": argv, "index": index, "step1": step1, "seeded": seeded}


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


def phase_sdxl_parity(torch, fa, cv, kernels):
    """SDXL at full width in fp32 (TF32 off), card against CPU on the same
    seeded weights: both text towers (`encode_prompt`: the penultimate
    states concatenated, the projected pooled output), one guided UNet call
    at 512^2, batch 1 (CFG 7.5, the added condition), and the decode of one
    latent. Each output within SDXL_PARITY_TOL of its max abs; the card's
    launches are the UNet's 70 A and the decode's 1 A and 21 B."""
    from comat_tpu_torch.diffusion.guidance import make_cfg_eps_model
    from comat_tpu_torch.models.pipeline import DiffusionPipeline
    from comat_tpu_torch.text.tokenizer import HashTokenizer

    cfg = fp32_config("sdxl", 512)
    t0 = time.perf_counter()
    # drawn on the card, copied to the CPU: the CPU's draws take seconds
    gpu = DiffusionPipeline(cfg, device="cuda", seed=SEED)
    cpu = DiffusionPipeline(cfg, device="cpu", params=gpu.state_dicts())
    n_par = {k: sum(p.numel() for p in m.parameters()) / 1e6
             for k, m in (("unet", cpu.unet), ("text", cpu.text), ("text2", cpu.text2),
                          ("vae", cpu.vae))}
    log(f"  weights made in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} M" for k, v in n_par.items()))
    tok, tok2 = HashTokenizer(cfg.text.vocab_size), HashTokenizer(cfg.text.vocab_size,
                                                                   pad_token_id=0)
    prompt = ["a red cube on top of a blue sphere"]
    enc, null = tok(prompt), tok([""])
    ids2, null2 = tok2(prompt)["input_ids"], tok2([""])["input_ids"]
    g = torch.Generator().manual_seed(SEED + 31)
    x = torch.randn(1, 64, 64, 4, generator=g)
    z = torch.randn(1, 64, 64, 4, generator=g)

    def run(pipe):
        dev = pipe.device
        with torch.no_grad():
            e = pipe.encode_prompt(enc["input_ids"], enc["eos_positions"], input_ids2=ids2)
            n = pipe.encode_prompt(null["input_ids"], None, input_ids2=null2)
            out = {"context": e.context, "pooled": e.pooled, "null_context": n.context,
                   "null_pooled": n.pooled}
            # the UNet on the CPU's encodings, so that it alone is compared
            c = {k: v.to(dev) for k, v in conds.items()} if conds else {
                k: v for k, v in out.items()}
            eps_model = make_cfg_eps_model(
                lambda lat, t, ctx, ac: pipe.unet_apply(lat, t, ctx, ac),
                c["context"], c["null_context"], 7.5, 0.0,
                pipe.sdxl_added_cond(c["pooled"], 1),
                pipe.sdxl_added_cond(c["null_pooled"], 1))
            out["eps"] = eps_model(x.to(dev), 981)
            out["image"] = pipe.decode_image(z.to(dev))
        return {k: v.float().cpu() for k, v in out.items()}

    conds = None
    t0 = time.perf_counter()
    want = run(cpu)
    t_cpu = time.perf_counter() - t0
    conds = {k: want[k] for k in ("context", "pooled", "null_context", "null_pooled")}
    del cpu
    gc.collect()
    reset(kernels)
    t0 = time.perf_counter()
    got = run(gpu)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    counts = {k: n for k, n in counts_by_role(fa, cv).items() if n}
    rels = {k: float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-12)
            for k in want}
    log(f"  card vs CPU (cpu {t_cpu:.1f} s, card {t_gpu:.1f} s), relative to each output's "
        f"max abs: " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
        + f"; shapes context {tuple(got['context'].shape)}, pooled "
        f"{tuple(got['pooled'].shape)}, eps {tuple(got['eps'].shape)}, image "
        f"{tuple(got['image'].shape)}; launches {counts}")
    worst = max(rels, key=rels.get)
    if not all(torch.isfinite(v).all() for v in got.values()) or not (
            rels[worst] <= SDXL_PARITY_TOL):
        raise AssertionError(f"SDXL {worst} differs by {rels[worst]:.3e} > {SDXL_PARITY_TOL}")
    want_counts = {"flash_fwd": SDXL_ATTN + 1, "conv_fwd": 21}
    if counts != want_counts:
        raise AssertionError(f"SDXL parity launched {counts}, expected {want_counts}")
    del gpu
    gc.collect()
    torch.cuda.empty_cache()
    return rels


def phase_sdxl_trainer(torch, fa, cv, kernels, cli_median, cli_peak):
    """The trainer CLI with comat_tpu_torch/scripts/sdxl.sh's flags (the
    launcher's own defaults; its --gan_model_arch gansd_1_5 D, Grounded-SAM,
    --gradient_checkpointing) at batch 6, 512^2, SDXL_STEPS steps, against a
    latent store the SDXL VAE encoder made, with a checkpoint at step 0 and
    at the end. Returns (launches by kernel and shape of the trainer's run,
    of the store's encoding, its medians, its peak memory GiB and the
    store's index, for phase 17)."""
    from comat_tpu_torch.train import main as train_main
    from comat_tpu_torch.training import train_step as ts
    from comat_tpu_torch.training.arguments import launcher_argv

    work = os.path.join(REPO, "build", "chip_smoke", "sdxl_trainer")  # build/ is ignored
    shutil.rmtree(work, ignore_errors=True)
    argv = launcher_argv(os.path.join(REPO, SDXL_LAUNCHER))
    i = argv.index("--training_prompts") + 1
    argv[i] = os.path.join(REPO, argv[i])
    index, encode_shapes = encode_latent_store(torch, fa, cv, kernels,
                                               os.path.join(work, "gan_store"), argv[i],
                                               sdxl=True, batch=SDXL_BATCH)
    out = os.path.join(work, "output")
    argv += ["--gan_gt_path", index, "--max_train_steps", str(SDXL_STEPS),
             "--output_dir", out]
    log("  argv: " + " ".join(argv))
    probe = lambda: counts_by_role(fa, cv)  # noqa: E731
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    trainer = train_main(argv, probe=probe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = counts_by_role(fa, cv)
    roles = _cli_roles(trainer)
    n_lora = sum(p.numel() for p in trainer.state.trainable.values()) / 1e6
    n_d = sum(p.numel() for p in trainer.d_state.trainable.values()) / 1e6
    log(f"  G: SDXL UNet {sum(p.numel() for p in trainer.pipeline.unet.parameters()) / 1e6:.1f}"
        f" M parameters ({n_lora:.1f} M LoRA); D: an SD1.5 UNet of its own (cross_arch "
        f"{trainer.disc.gan_cfg.cross_arch}), {n_d:.1f} M trainable")
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    keys = ("s_step", *ts.PHASES)
    for r in rows:
        log(f"  step {r['step']}: loss {r['step_loss']:.4f}, G_loss {r['G_loss']:.4f}, "
            f"D_loss {r['D_loss']:.4f}, token_loss {r['token_loss']:.4f}, grad_norm "
            f"{r['grad_norm']:.4e}; {r['sec_per_step']:.3f} s wall; "
            + ", ".join(f"{k} {r[k]:.3f}" for k in keys))
    median = _median(rows[1:], ("sec_per_step",) + keys)
    log(f"  sdxl_trainer: {median['s_step']:.3f} s per step on the device "
        f"({median['sec_per_step']:.3f} s wall, median of steps 2-{SDXL_STEPS}), peak "
        f"memory {peak:.1f} GiB, run {wall:.1f} s (2 checkpoints); phase 9, same run: "
        f"{cli_median['s_step']:.3f} s, {cli_peak:.1f} GiB")
    log("  split: " + ", ".join(f"{k} {median[k]:.3f} s" for k in ts.PHASES))
    want_roles = {role: {k: n * SDXL_STEPS for k, n in c.items()}
                  for role, c in SDXL_CLI_LAUNCHES.items()}
    for role in FULL_ROLES:
        log(f"  launches by role, {SDXL_STEPS} steps: {role} {roles[role]} (predicted "
            f"{want_roles[role]})")
    want = {k: sum(c.get(k, 0) for c in want_roles.values()) for k in counts}
    log(f"  launches in all {counts}, predicted {want}")
    if len(rows) != SDXL_STEPS or not all(
            math.isfinite(r[k]) for r in rows for k in ("step_loss", "G_loss", "D_loss",
                                                        "token_loss", "pixel_loss",
                                                        "grad_norm")):
        raise AssertionError(f"SDXL trainer metrics: {rows}")
    if not (trainer.pcfg.is_sdxl and trainer.disc.gan_cfg.cross_arch
            and all(r["s_segment"] > 0 for r in rows)):
        raise AssertionError("the SDXL trainer did not run the recipe's D and split step")
    if roles != want_roles or counts != want:
        raise AssertionError(f"SDXL trainer launched {counts} ({roles}), expected {want} "
                             f"({want_roles})")
    ckpts = sorted(d for d in os.listdir(out) if d.startswith("checkpoint-"))
    last = os.path.join(out, f"checkpoint-{SDXL_STEPS}")
    log(f"  {ckpts}, {sorted(os.listdir(last))}")
    if ckpts != ["checkpoint-0", f"checkpoint-{SDXL_STEPS}"] or not os.path.isfile(
            os.path.join(last, "pytorch_lora_weights.safetensors")):
        raise AssertionError(f"SDXL trainer output: {ckpts}")
    shapes = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return shapes, encode_shapes, median, peak, index


_ST_DTYPES = {"torch.float32": "F32", "torch.float16": "F16", "torch.int64": "I64"}


def write_safetensors(torch, path, tensors, dtype=None) -> int:
    """`tensors` (name -> tensor, on any device) as a .safetensors file,
    each floating tensor cast to `dtype` where given, one tensor at a time
    on its way to the host. Returns the bytes written."""
    def out_dtype(t):
        return dtype if dtype is not None and t.is_floating_point() else t.dtype

    names = sorted(tensors)
    header, offset = {}, 0
    for n in names:
        t = tensors[n]
        size = t.numel() * torch.empty((), dtype=out_dtype(t)).element_size()
        header[n] = {"dtype": _ST_DTYPES[str(out_dtype(t))], "shape": list(t.shape),
                     "data_offsets": [offset, offset + size]}
        offset += size
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for n in names:
            t = tensors[n].detach().to("cpu", out_dtype(tensors[n])).contiguous()
            f.write(t.numpy().tobytes())
    return 8 + len(text) + offset


def hub_snapshot(cache, repo_id, rev="0123abc"):
    """cache/models--org--name/snapshots/<rev>, refs/main naming it."""
    base = os.path.join(cache, "models--" + repo_id.replace("/", "--"))
    os.makedirs(os.path.join(base, "refs"))
    with open(os.path.join(base, "refs", "main"), "w") as f:
        f.write(rev)
    return os.path.join(base, "snapshots", rev)


def diffusers_unet(state, conv_proj):
    """The port UNet's tensors under diffusers' names (the LoRA factors
    left out); `conv_proj`: the transformers' proj_in / proj_out as 1x1
    convs, as SD1.5's file holds them."""
    out = {}
    for n, v in state.items():
        if "lora_" in n:
            continue
        n = n.replace(".base.", ".")
        if conv_proj and re.search(r"\.attentions\.\d+\.proj_(in|out)\.weight$", n):
            v = v[:, :, None, None]
        out[n] = v
    return out


def old_vae_names(state):
    """The VAE's mid-block attention under the names older diffusers saved
    (the SD1.5 repository's VAE file holds them)."""
    old = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
    out = {}
    for n, v in state.items():
        m = re.fullmatch(r"(.+\.mid_block\.attentions\.0)\.(to_q|to_k|to_v|to_out\.0)\.(.+)", n)
        out[f"{m.group(1)}.{old[m.group(2)]}.{m.group(3)}" if m else n] = v
    return out


class RssPeak:
    """The process's resident set, sampled every 2 ms on a thread while
    the block runs: `base` before it, `peak` the largest sample."""

    def __enter__(self):
        self.base = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, self._rss())

    @staticmethod
    def _rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def _load_line(what, r):
    secs = r.read_s + r.copy_s
    return (f"{what}: {r.nbytes / 1e9:.3f} GB, read {r.read_s:.3f} s "
            f"({r.nbytes / 1e9 / max(r.read_s, 1e-9):.2f} GB/s), copy to the card "
            f"{r.copy_s:.3f} s ({r.nbytes / 1e9 / max(r.copy_s, 1e-9):.2f} GB/s), "
            f"{secs:.3f} s in all")


def phase_snapshots(torch, fa, cv, kernels, gen, cli):
    """Synthetic snapshots in the HF hub cache layout under a temporary
    folder (deleted at the end, pass or fail): SD1.5 (phase 9's seeded
    towers, fp32, the VAE's attention under older diffusers' names) and
    BLIP-large (phase 9's seeded captioner, the tied LM head dropped), then
    SDXL (seeded, the base repository's fp16 variant files). (a) the
    generator from the SD1.5 snapshot, phase 5's prompts, seed and draws:
    phase 5's image, bit for bit, and its launches; (c) the trainer on
    sd15.sh's flags, its default ids resolved in the cache, for
    SNAPSHOT_STEPS steps: (d) every tower and the captioner equal the
    seeded ones, nothing missing or unused, no smoke fallback for weights;
    (e) step 1's loss and every G and D trained tensor after it equal phase
    9's step 1, bit for bit; (f) its launches by role equal phase 9's a
    step; then the SDXL snapshot into a fresh SDXL pipeline: every tensor
    the fp16 value widened and rounded once, no tensor missing, the peak
    host RSS of the load. Returns the launches by kernel and shape of the
    generation and of the trainer's run."""
    from comat_tpu_torch.models.hf_import import load_sd_state
    from comat_tpu_torch.models.pipeline import DiffusionPipeline, make_pipeline_config
    from comat_tpu_torch.tools.generate import main as generate_main
    from comat_tpu_torch.training.arguments import launcher_argv, parse_args
    from comat_tpu_torch.training.trainer import Trainer

    _, gen_images, gen_argv = gen
    t_phase = time.perf_counter()
    parent = os.path.join(REPO, "build", "chip_smoke")     # build/ is ignored
    os.makedirs(parent, exist_ok=True)
    work = tempfile.mkdtemp(prefix="snapshots-", dir=parent)
    try:
        free = shutil.disk_usage(work).free / 1e9
        cache = os.path.join(work, "hub")
        seeded = cli["seeded"]
        t0 = time.perf_counter()
        sd = hub_snapshot(cache, SD15_ID)
        nbytes = write_safetensors(
            torch, os.path.join(sd, "unet", "diffusion_pytorch_model.safetensors"),
            diffusers_unet(seeded["unet"], conv_proj=True), torch.float32)
        nbytes += write_safetensors(
            torch, os.path.join(sd, "vae", "diffusion_pytorch_model.safetensors"),
            old_vae_names(seeded["vae"]), torch.float32)
        nbytes += write_safetensors(
            torch, os.path.join(sd, "text_encoder", "model.safetensors"),
            {**seeded["text"], "text_model.embeddings.position_ids": torch.arange(77)[None]},
            torch.float32)
        blip = hub_snapshot(cache, CAPTION_ID)
        head = "text_decoder.cls.predictions.decoder.weight"
        blip_bytes = write_safetensors(
            torch, os.path.join(blip, "model.safetensors"),
            {**{n: v for n, v in seeded["blip"].items() if n != head},
             "text_decoder.bert.embeddings.position_ids": torch.arange(512)[None]},
            torch.float32)
        log(f"  wrote SD1.5 ({nbytes / 1e9:.3f} GB, fp32: UNet "
            f"{sum(v.numel() for v in seeded['unet'].values()) / 1e6:.1f} M, CLIP-L "
            f"{sum(v.numel() for v in seeded['text'].values()) / 1e6:.1f} M, VAE "
            f"{sum(v.numel() for v in seeded['vae'].values()) / 1e6:.1f} M parameters) and "
            f"BLIP-large ({blip_bytes / 1e9:.3f} GB) in {time.perf_counter() - t0:.1f} s "
            f"under {work} ({free:.0f} GB free before)")

        # (a) the generator from the snapshot
        reset(kernels)
        images, timings = generate_main(gen_argv + ["--pretrain-model", SD15_ID,
                                                    "--cache-dir", cache])
        torch.cuda.synchronize()
        counts = [kernels[0].launches, kernels[3].launches]
        snap_gen_shapes = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
        same = torch.equal(images.cpu(), gen_images)
        log(f"  generation from the snapshot: {timings['sample_s'] / 50:.4f} s/step; image "
            f"equal to phase 5's: {same}; launches flash {counts[0]}, conv {counts[1]}")
        if not same:
            diff = float((images.cpu().float() - gen_images.float()).abs().max())
            raise AssertionError(f"the image from the snapshot differs from phase 5's "
                                 f"(max |diff| {diff:.3e})")
        if counts != [MAIN_FLASH_LAUNCHES, MAIN_CONV_LAUNCHES]:
            raise AssertionError(f"generation from the snapshot launched {counts}")

        # (c) the trainer, its default ids resolved in the cache
        argv = launcher_argv(os.path.join(REPO, SD15_LAUNCHER))
        i = argv.index("--training_prompts") + 1
        argv[i] = os.path.join(REPO, argv[i])
        out = os.path.join(work, "output")
        argv += ["--gan_gt_path", cli["index"], "--cache_dir", cache, "--max_train_steps",
                 str(SNAPSHOT_STEPS), "--num_validation_images", "0", "--output_dir", out]
        log("  argv: " + " ".join(argv))
        probe = lambda: counts_by_role(fa, cv)  # noqa: E731
        gc.collect()
        torch.cuda.empty_cache()
        reset(kernels)
        t0 = time.perf_counter()
        trainer = Trainer(parse_args(argv), probe=probe)
        t_build = time.perf_counter() - t0
        step1 = record_first_step(trainer)
        trainer.train()
        trainer.metrics.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap_cli_shapes = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
        log(f"  trainer: snapshot {trainer.snapshot}, caption model {trainer.caption_dir}; "
            f"built in {t_build:.1f} s, {SNAPSHOT_STEPS} steps and 2 checkpoints, "
            f"{wall:.1f} s in all")
        log("  " + gpu_name_and_power())
        for what, r in trainer.load_reports.items():
            log("    load " + _load_line(what, r))
        reports = {w: (len(r.missing), len(r.unused)) for w, r in trainer.load_reports.items()}
        weight_fallbacks = [why for kind, why in trainer.smoke_fallbacks if kind == "weights"]
        log(f"  (missing, unused) by load: {reports}; smoke fallbacks taken: "
            f"{[kind for kind, _ in trainer.smoke_fallbacks]}")
        if sorted(reports) != ["caption_model", "text", "unet", "vae"] or any(
                m or u for m, u in reports.values()) or weight_fallbacks:
            raise AssertionError(f"snapshot loads: {reports}, weight fallbacks "
                                 f"{weight_fallbacks}")
        # (d) every tower as phase 9 seeded it
        bad = []
        for tower, module in (("unet", trainer.pipeline.unet), ("text", trainer.pipeline.text),
                              ("vae", trainer.pipeline.vae), ("blip", trainer.blip)):
            got = module.state_dict()
            bad += [f"{tower}.{n}" for n, v in seeded[tower].items()
                    if not torch.equal(got[n].cpu(), v)]
        n_seeded = sum(len(v) for v in seeded.values())
        log(f"  {n_seeded} tower and captioner tensors against phase 9's seeded ones: "
            f"{len(bad)} differ {bad[:3]}")
        if bad:
            raise AssertionError(f"{len(bad)} loaded tensors differ from the seeded: {bad[:5]}")
        # (e) step 1 as phase 9's
        ref = cli["step1"]
        differ = [f"g.{n}" for n, v in step1["g"].items() if not torch.equal(v, ref["g"][n])]
        differ += [f"d.{n}" for n, v in step1["d"].items() if not torch.equal(v, ref["d"][n])]
        log(f"  step 1: loss {step1['loss']!r} (phase 9 {ref['loss']!r}); "
            f"{len(step1['g'])} G and {len(step1['d'])} D trained tensors, "
            f"{len(differ)} differ from phase 9's {differ[:3]}")
        if step1["loss"] != ref["loss"] or differ or set(step1["g"]) != set(ref["g"]):
            raise AssertionError("step 1 from the snapshot differs from phase 9's")
        # (f) launches by role, as phase 9's a step
        roles = _cli_roles(trainer)
        want_roles = {role: {k: n * SNAPSHOT_STEPS for k, n in c.items()}
                      for role, c in CLI_LAUNCHES.items()}
        log(f"  launches by role, {SNAPSHOT_STEPS} steps: {roles}")
        if roles != want_roles:
            raise AssertionError(f"trainer from the snapshot launched {roles}, expected "
                                 f"{want_roles}")
        del trainer, step1
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(sd)
        shutil.rmtree(blip)

        # SDXL: the base repository's fp16 variant files
        cfg = make_pipeline_config("sdxl", lora_rank=0)
        src = DiffusionPipeline(cfg, "cuda", seed=SEED)
        xl = hub_snapshot(cache, SDXL_ID)
        t0 = time.perf_counter()
        files = {"unet": ("unet", "diffusion_pytorch_model",
                          diffusers_unet(src.unet.state_dict(), conv_proj=False)),
                 "vae": ("vae", "diffusion_pytorch_model", src.vae.state_dict()),
                 "text": ("text_encoder", "model", src.text.state_dict()),
                 "text2": ("text_encoder_2", "model", src.text2.state_dict())}
        nbytes = sum(write_safetensors(torch, os.path.join(xl, sub, f"{stem}.fp16.safetensors"),
                                       tensors, torch.float16)
                     for sub, stem, tensors in files.values())
        n_par = {t: sum(v.numel() for v in f[2].values()) / 1e6 for t, f in files.items()}
        log(f"  wrote SDXL's fp16 variant files ({nbytes / 1e9:.3f} GB: "
            + ", ".join(f"{t} {v:.1f} M" for t, v in n_par.items())
            + f" parameters) in {time.perf_counter() - t0:.1f} s")
        del files
        dst = DiffusionPipeline(cfg, "cuda", seed=SEED + 1)
        gc.collect()
        with RssPeak() as rss:
            t0 = time.perf_counter()
            xl_reports = load_sd_state(os.path.join(xl), dst)
            load_s = time.perf_counter() - t0
        log("  " + gpu_name_and_power())
        for tower, r in xl_reports.items():
            log("    SDXL load " + _load_line(tower, r))
        gb = sum(r.nbytes for r in xl_reports.values()) / 1e9
        log(f"  SDXL load {load_s:.3f} s in all ({gb / load_s:.2f} GB/s); host RSS "
            f"{rss.base / 1e9:.3f} GB before, peak {rss.peak / 1e9:.3f} GB during "
            f"(+{(rss.peak - rss.base) / 1e9:.3f} GB against {nbytes / 1e9:.3f} GB of files)")
        bad = []
        for tower, r in xl_reports.items():
            if r.missing or r.unused:
                bad.append(f"{tower}: missing {r.missing[:3]}, unused {r.unused[:3]}")
            want = getattr(src, tower).state_dict()
            for n, v in getattr(dst, tower).state_dict().items():
                if not torch.equal(v, want[n].to(torch.float16).float().to(v.dtype)):
                    bad.append(f"{tower}.{n}")
        log(f"  SDXL tensors against the fp16 values written, widened and rounded once: "
            f"{len(bad)} differ {bad[:3]}")
        if bad:
            raise AssertionError(f"SDXL snapshot load: {bad[:5]}")
        del src, dst
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  phase 13: {time.perf_counter() - t_phase:.1f} s")
        return snap_gen_shapes, snap_cli_shapes
    finally:
        shutil.rmtree(work, ignore_errors=True)


# phase 14: the port's GAN latent tool makes a store from the corpus'
# first prompts, then the trainer takes sd15.sh's flags on it with
# gradient accumulation; the store samples each batch with the fused UNet
# (15 A a call, 50 calls) and decodes nothing
GAN_GT_CORPUS = os.path.join("merged_data", "abc5k_hrs10k_t2icompall_20k.txt")
GAN_GT_PROMPTS, GAN_GT_BATCH = 8, 4
GAN_GT_LAUNCHES = {"flash_fwd": 15 * 50 * (GAN_GT_PROMPTS // GAN_GT_BATCH)}
ACCUM_N, ACCUM_STEPS, ACCUM_RESUME = 2, 4, 3
# phase 15: BLIP-VQA at base width, card against CPU in fp32 (relative to
# each output's max abs), then the evaluator on 4 attribute-bearing
# prompts in one batch: 50 guided UNet calls and the decode
VQA_PARITY_TOL = 1e-3
EVAL_PROMPTS = 4
EVAL_LAUNCHES = {"flash_fwd": 751, "conv_fwd": 21}
COLOURS = ("red", "blue", "green", "yellow", "white", "black", "brown", "orange", "pink",
           "purple")


def _write_prompts(path, prompts) -> str:
    with open(path, "w") as f:
        f.write("\n".join(prompts) + "\n")
    return path


def _trained(module_state):
    return {n: p.detach().clone() for n, p in module_state.items()}


def phase_gan_store_accum(torch, fa, cv, kernels, cli_median, cli_peak):
    """(a) `tools.gan_gt_generate.main` writes a latent store for the
    corpus' first GAN_GT_PROMPTS prompts at 512^2 (SD1.5 seeded with the
    launcher's seed, as phase 9's trainer seeds it; batch GAN_GT_BATCH, 50
    DDPM steps): A launches only, every prompt read back at (64, 64, 4)
    finite, and a second call with --use-cache generates nothing. (b) The
    trainer on sd15.sh's flags over those prompts and that store, with
    --gradient_accumulation_steps ACCUM_N, for ACCUM_STEPS micro-steps and
    a checkpoint at ACCUM_RESUME: no smoke fallback of kind "data", the
    LoRA factors unchanged after a micro-step and all changed after an
    applying step, D's tensors all changed every step, the launches by role
    phase 9's a micro-step; then a run resumed from checkpoint-ACCUM_RESUME
    (between two updates) ends with the uninterrupted run's checkpoint,
    bit for bit. Returns (launches by kernel and shape of the store, of the
    trainer's runs)."""
    import numpy as np

    from comat_tpu_torch.tools.gan_gt_generate import main as gan_main
    from comat_tpu_torch.training.arguments import launcher_argv, parse_args
    from comat_tpu_torch.training.data import GanLatentStore, load_prompts
    from comat_tpu_torch.training.trainer import Trainer

    work = os.path.join(REPO, "build", "chip_smoke", "accum")   # build/ is ignored
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    prompts = load_prompts(os.path.join(REPO, GAN_GT_CORPUS))[:GAN_GT_PROMPTS]
    ppath = _write_prompts(os.path.join(work, "prompts.txt"), prompts)
    store = os.path.join(work, "gan_store")
    gan_argv = ["--model", "sd_1_5", "--prompt-path", ppath, "--save-path", store,
                "--batch-size", str(GAN_GT_BATCH), "--num-inference-steps", "50",
                "--resolution", "512", "--seed", str(TRAINER_SEED), "--allow-smoke",
                "--device", "cuda"]
    log("  argv: " + " ".join(gan_argv))
    reset(kernels)
    t0 = time.perf_counter()
    made = gan_main(gan_argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: n for k, n in counts_by_role(fa, cv).items() if n}
    store_shapes = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
    batch_s = made["batch_s"]
    log("  " + gpu_name_and_power())
    log(f"  latent store: {made['generated']} prompts in {len(batch_s)} batches of "
        f"{GAN_GT_BATCH}, {wall:.1f} s in all (build and weights included); seconds a batch "
        + ", ".join(f"{b:.3f}" for b in batch_s)
        + f" ({batch_s[-1] / 50:.4f} s a denoising step, the last batch); launches {counts} "
        f"(predicted {GAN_GT_LAUNCHES})")
    if counts != GAN_GT_LAUNCHES or made["generated"] != GAN_GT_PROMPTS:
        raise AssertionError(f"latent store: {made['generated']} prompts, launches {counts}")
    index = os.path.join(store, "index.jsonl")
    lat = GanLatentStore(index).batch(prompts)
    log(f"  store read back: {lat.shape}, std {lat.std():.4f}, finite {np.isfinite(lat).all()}")
    if lat.shape != (GAN_GT_PROMPTS, 64, 64, 4) or not np.isfinite(lat).all():
        raise AssertionError(f"bad latents {lat.shape}")
    again = gan_main(gan_argv + ["--use-cache"])
    n_lines = sum(1 for line in open(index) if line.strip())
    if again["generated"] or n_lines != GAN_GT_PROMPTS:
        raise AssertionError(f"--use-cache generated {again['generated']}, index {n_lines}")

    argv = launcher_argv(os.path.join(REPO, SD15_LAUNCHER))
    argv[argv.index("--training_prompts") + 1] = ppath
    argv += ["--gan_gt_path", index, "--gradient_accumulation_steps", str(ACCUM_N),
             "--max_train_steps", str(ACCUM_STEPS), "--validation_steps", str(ACCUM_RESUME),
             "--num_validation_images", "0"]
    out = os.path.join(work, "output")
    log("  argv: " + " ".join(argv))
    probe = lambda: counts_by_role(fa, cv)  # noqa: E731
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30    # by earlier phases
    reset(kernels)
    t0 = time.perf_counter()
    trainer = Trainer(parse_args(argv + ["--output_dir", out]), probe=probe)
    data_fallbacks = [why for kind, why in trainer.smoke_fallbacks if kind == "data"]
    # which trained tensors each micro-step changed, G's and D's
    prev = {"g": _trained(trainer.state.trainable), "d": _trained(trainer.d_state.trainable)}
    moves, inner = [], trainer.train_step

    def step(state, batch, **kw):
        state, metrics = inner(state, batch, **kw)
        moved = []
        for key, tensors in (("g", state.trainable), ("d", trainer.d_state.trainable)):
            moved.append(sum(not torch.equal(p.detach(), prev[key][n])
                             for n, p in tensors.items()))
            for n, p in tensors.items():
                prev[key][n].copy_(p.detach())
        moves.append(tuple(moved))
        return state, metrics

    trainer.train_step = step
    trainer.train()
    trainer.metrics.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    roles = _cli_roles(trainer)
    n_g, n_d = len(trainer.state.trainable), len(trainer.d_state.trainable)
    acc_mb = sum(a.numel() * a.element_size()
                 for a in trainer.state.optimizer.acc.values()) / 2 ** 20
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    for r in rows:
        kind = "applying" if r["step"] % ACCUM_N == 0 else "micro"
        log(f"  step {r['step']} ({kind}): loss {r['step_loss']:.4f}, D_loss "
            f"{r['D_loss']:.4f}, grad_norm {r['grad_norm']:.4e}; s_step {r['s_step']:.3f}, "
            f"wall {r['sec_per_step']:.3f}, s_optimizer {r['s_optimizer']:.4f} s")
    micro = [r for r in rows[1:] if r["step"] % ACCUM_N]
    applying = [r for r in rows[1:] if r["step"] % ACCUM_N == 0]
    m_micro = _median(micro, ("s_step", "sec_per_step", "s_optimizer"))
    m_apply = _median(applying, ("s_step", "sec_per_step", "s_optimizer"))
    log("  " + gpu_name_and_power())
    log(f"  accumulation {ACCUM_N}: micro-step {m_micro['s_step']:.3f} s on the device "
        f"({m_micro['sec_per_step']:.3f} s wall, optimizer {m_micro['s_optimizer']:.4f} s; "
        f"steps {[r['step'] for r in micro]}), applying step {m_apply['s_step']:.3f} s "
        f"({m_apply['sec_per_step']:.3f} s wall, optimizer {m_apply['s_optimizer']:.4f} s; "
        f"steps {[r['step'] for r in applying]}); phase 9's step {cli_median['s_step']:.3f} s "
        f"({cli_median['sec_per_step']:.3f} s wall); peak memory {peak:.2f} GiB, "
        f"{peak - held:.2f} above the {held:.2f} GiB held before the trainer (phase 9's "
        f"peak {cli_peak:.2f}; the running mean {acc_mb:.1f} MiB); run {wall:.1f} s")
    log(f"  tensors changed a micro-step (G of {n_g}, D of {n_d}): {moves}; smoke "
        f"fallbacks {[kind for kind, _ in trainer.smoke_fallbacks]}")
    want_moves = [(n_g if (i + 1) % ACCUM_N == 0 else 0, n_d) for i in range(ACCUM_STEPS)]
    if data_fallbacks or moves != want_moves:
        raise AssertionError(f"accumulation: moves {moves}, expected {want_moves}; data "
                             f"fallbacks {data_fallbacks}")
    want_roles = {role: {k: n * ACCUM_STEPS for k, n in c.items()}
                  for role, c in CLI_LAUNCHES.items()}
    log(f"  launches by role, {ACCUM_STEPS} micro-steps: {roles}")
    if roles != want_roles or len(rows) != ACCUM_STEPS or not all(
            math.isfinite(r[k]) for r in rows for k in ("step_loss", "G_loss", "D_loss",
                                                        "grad_norm")):
        raise AssertionError(f"accumulated trainer: roles {roles} (expected {want_roles}), "
                             f"rows {rows}")
    accum_shapes = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
    del trainer, prev
    gc.collect()
    torch.cuda.empty_cache()

    res_out = os.path.join(work, "resumed")
    mid = os.path.join(out, f"checkpoint-{ACCUM_RESUME}")
    shutil.copytree(mid, os.path.join(res_out, f"checkpoint-{ACCUM_RESUME}"))
    reset(kernels)
    resumed = Trainer(parse_args(argv + ["--output_dir", res_out,
                                         "--resume_from_checkpoint", "latest"]), probe=probe)
    opt = resumed.state.optimizer
    log(f"  resumed at micro-step {resumed.global_step}: update count {opt.count}, "
        f"micro-step counter {opt.mini_step}, running mean of {len(opt.acc)} tensors")
    if (resumed.global_step, opt.count, opt.mini_step) != (
            ACCUM_RESUME, ACCUM_RESUME // ACCUM_N, ACCUM_RESUME % ACCUM_N) or not opt.acc:
        raise AssertionError("the resumed trainer does not hold the accumulation state")
    resumed.train()
    resumed.metrics.close()
    torch.cuda.synchronize()
    roles = _cli_roles(resumed)
    if roles != {role: dict(c) for role, c in CLI_LAUNCHES.items()}:
        raise AssertionError(f"resumed run launched {roles}")
    a = torch.load(os.path.join(out, f"checkpoint-{ACCUM_STEPS}", "state.pt"),
                   weights_only=True)
    b = torch.load(os.path.join(res_out, f"checkpoint-{ACCUM_STEPS}", "state.pt"),
                   weights_only=True)
    differ = [f"{key}.{n}" for key in ("trainable", "d_trainable")
              for n in a[key] if not torch.equal(a[key][n], b[key][n])]
    for key in ("optimizer", "d_optimizer"):
        sa, sb = a[key]["adam"]["state"], b[key]["adam"]["state"]
        differ += [f"{key}.{i}.{m}" for i in sa for m in sa[i] if torch.is_tensor(sa[i][m])
                   and not torch.equal(sa[i][m].cpu(), sb[i][m].cpu())]
    differ += [f"acc.{n}" for n in a["optimizer"]["acc"]
               if not torch.equal(a["optimizer"]["acc"][n], b["optimizer"]["acc"][n])]
    row = json.loads(open(os.path.join(res_out, "metrics.jsonl")).read().splitlines()[-1])
    same = (not differ and torch.equal(a["generator"], b["generator"])
            and a["extra"] == b["extra"] and row["step_loss"] == rows[-1]["step_loss"]
            and a["optimizer"]["mini_step"] == b["optimizer"]["mini_step"] == 0)
    log(f"  resumed checkpoint-{ACCUM_STEPS} against the uninterrupted run's: "
        f"{len(differ)} tensors differ {differ[:3]}; step loss {row['step_loss']!r} "
        f"({rows[-1]['step_loss']!r}); bit for bit: {same}")
    if not same:
        raise AssertionError("the resumed accumulated run does not repeat the uninterrupted one")
    for kern in kernels:
        acc = accum_shapes.setdefault(kern.symbol, {})
        for key, n in kern.launches_by_shape.items():
            acc[key] = acc.get(key, 0) + n
    del resumed, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return store_shapes, accum_shapes


def phase_evaluate(torch, fa, cv, kernels):
    """(a) BLIP-VQA at base width (ViT-B/16) in fp32, seeded, card against
    CPU on 2 images x 3 questions: both answer log-likelihoods and P(yes)
    within VQA_PARITY_TOL of each one's max abs. (b) `tools.evaluate.main`
    at 512^2 on the corpus' first EVAL_PROMPTS prompts with a colour word,
    one batch, --metric both --allow-smoke (seeded SD1.5 with the
    launcher's seed, captioner and VQA): one row per prompt with its
    questions, every P(yes) in [0, 1], a finite reward, the launches of
    one generation and decode. Returns the launches by kernel and shape of
    (b)."""
    import numpy as np

    from comat_tpu_torch.config import BLIPConfig
    from comat_tpu_torch.models.blip_vqa import build_answer_batch, encode_fixed, make_blip_vqa
    from comat_tpu_torch.text.tokenizer import HashTokenizer
    from comat_tpu_torch.tools.evaluate import main as eval_main
    from comat_tpu_torch.training.data import load_prompts

    cfg = dataclasses.replace(BLIPConfig.base(), dtype=torch.float32)
    t0 = time.perf_counter()
    cpu = make_blip_vqa(cfg, "cpu", seed=SEED + 11)
    card = make_blip_vqa(cfg, "cuda", params=cpu.state_dict())
    gen = torch.Generator().manual_seed(SEED + 12)
    H = cfg.image_size
    pix = torch.randn(2, H, H, 3, generator=gen).repeat_interleave(3, dim=0)
    tok = HashTokenizer(cfg.vocab_size)
    questions = ["red cube?", "blue sphere?", "a red cube on a blue sphere?",
                 "two cats?", "green umbrella?", "cats?"]
    q = [torch.from_numpy(a) for a in encode_fixed(tok, questions, 16)]
    ans = [torch.from_numpy(a) for word in ("yes", "no") for a in build_answer_batch(
        tok, [word], len(questions), 8, bos_token_id=cfg.bos_token_id)]
    with torch.no_grad():
        want = cpu.answer_logliks(pix, *q, *ans)
        t1 = time.perf_counter()
        got = card.answer_logliks(pix.cuda(), *(a.cuda() for a in q + ans))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    outs = {"ll_yes": (got[0], want[0]), "ll_no": (got[1], want[1]),
            "p_yes": (torch.sigmoid(got[0] - got[1]), torch.sigmoid(want[0] - want[1]))}
    errs = {k: float((g.cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for k, (g, w) in outs.items()}
    log(f"  BLIP-VQA base fp32 ({sum(p.numel() for p in cpu.parameters()) / 1e6:.1f} M "
        f"parameters), 2 images x 3 questions: CPU {t1 - t0:.1f} s with the build, card "
        f"{t2 - t1:.3f} s; P(yes) {[round(float(p), 4) for p in outs['p_yes'][1]]}; "
        f"|card - CPU| / max abs: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if not all(math.isfinite(v) and v <= VQA_PARITY_TOL for v in errs.values()):
        raise AssertionError(f"BLIP-VQA card against CPU: {errs}")
    del cpu, card

    work = os.path.join(REPO, "build", "chip_smoke", "evaluate")   # build/ is ignored
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    corpus = load_prompts(os.path.join(REPO, GAN_GT_CORPUS))
    prompts = [p for p in corpus if any(c in p.lower().split() for c in COLOURS)][:EVAL_PROMPTS]
    argv = ["--prompt-path", _write_prompts(os.path.join(work, "prompts.txt"), prompts),
            "--out", os.path.join(work, "results.jsonl"), "--batch-size", str(EVAL_PROMPTS),
            "--metric", "both", "--allow-smoke", "--seed", str(TRAINER_SEED),
            "--resolution", "512", "--num-inference-steps", "50", "--device", "cuda"]
    log("  argv: " + " ".join(argv))
    gc.collect()
    torch.cuda.empty_cache()
    reset(kernels)
    t0 = time.perf_counter()
    res = eval_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: n for k, n in counts_by_role(fa, cv).items() if n}
    shapes = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
    sec = res["seconds"]
    log("  " + gpu_name_and_power())
    log(f"  evaluator: {len(res['rows'])} rows, summary {res['summary']}; seconds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sec.items())
        + f" ({sec['generate'] / 50:.4f} s a denoising step); {wall:.1f} s in all with the "
        f"three models' build; launches {counts} (predicted {EVAL_LAUNCHES})")
    rows = res["rows"]
    if (len(rows) != EVAL_PROMPTS or counts != EVAL_LAUNCHES
            or not all(r["bvqa_questions"] and all(0.0 <= p <= 1.0 for p in r["bvqa_p_yes"])
                       and math.isfinite(r["blip_reward"]) for r in rows)
            or not np.isfinite(res["summary"]["mean_bvqa_binding"])):
        raise AssertionError(f"evaluator: rows {rows}, launches {counts}")
    return shapes


SURFACE_FLAGS = ["--full_finetuning", "--use_8bit_adam", "--train_text_encoder_lora",
                 "--tune_text_encoder"]
SURF_TEXT_RANK = 8
SURF_STEPS, SURF_RESUME = 3, 2
# phase 16(a): 4 pass-1 steps and K 2 replay recomputes of the 10 flash
# self-attentions at 256^2, and the decode's
SURF_PARITY_LAUNCHES = {"flash_fwd": 10 * (4 + 2) + 1, "dq": 10 * 2 + 1, "dkv": 10 * 2 + 1,
                        "conv_fwd": 14, "conv_dx": 14, "dw": 0}
SXS_STEPS = 2
SXS_BATCHES = (SDXL_BATCH, 4, 2)


def _gib(torch) -> str:
    return (f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved")


def _leaf_rels(grads_gpu, grads_cpu):
    """Per leaf: max |card - CPU| over the larger max |gradient|, and the
    leaves whose CPU gradient is below ZERO_LEAF_REL of the largest (zero
    in exact arithmetic): their largest |g| over the largest gradient."""
    scale = max(float(g.abs().max()) for g in grads_cpu.values())
    rels, zero_leaves = {}, {}
    for name, gc_ in grads_cpu.items():
        gg, gc_ = grads_gpu[name].double(), gc_.double()
        peak = max(float(gg.abs().max()), float(gc_.abs().max()))
        if float(gc_.abs().max()) < ZERO_LEAF_REL * scale:
            zero_leaves[name] = peak / scale
        else:
            rels[name] = float((gg - gc_).abs().max()) / max(peak, 1e-12)
    return rels, zero_leaves


def phase_surfaces_parity(torch, fa, cv, kernels):
    """16(a): one make_loss_fn value and backward of the SD1.5 step with
    every trainable surface on, at phase 4's geometry in fp32 (256^2,
    total_step 4, K 2, batch 1, SD1.5 and BLIP-large at full width), the
    BLIP reward alone: the whole UNet (--full_finetuning) with LoRA 128,
    CLIP-L whole (--tune_text_encoder) with LoRA 8 on its attention
    (--train_text_encoder_lora), nonzero lora_b, on the card and on the
    CPU."""
    from comat_tpu_torch.config import BLIPConfig
    from comat_tpu_torch.models.blip import make_blip
    from comat_tpu_torch.models.pipeline import DiffusionPipeline
    from comat_tpu_torch.training import train_step as ts

    cfg = dataclasses.replace(fp32_config("sd_1_5", 256, lora_rank=128),
                              text_lora_rank=SURF_TEXT_RANK)
    bcfg = dataclasses.replace(BLIPConfig.large(), dtype=torch.float32)
    tcfg = ts.TrainConfig(total_step=4, K=2, resolution=256, train_text_encoder=True)
    t0 = time.perf_counter()
    # drawn on the card, copied to the CPU: the CPU's draws take seconds
    gpu = DiffusionPipeline(cfg, device="cuda", seed=SEED)
    g = torch.Generator().manual_seed(SEED + 11)
    _nonzero_lora_b(torch, gpu.unet, g)
    _nonzero_lora_b(torch, gpu.text, g)
    cpu = DiffusionPipeline(cfg, device="cpu", params=gpu.state_dicts())
    blip_gpu = make_blip(bcfg, device="cuda", seed=SEED + 1)
    blip_cpu = make_blip(bcfg, device="cpu", params=blip_gpu.state_dict())
    log(f"  weights made in {time.perf_counter() - t0:.1f} s")
    batch = _train_batch(TRAIN_PROMPTS[:1], cfg.text.vocab_size, bcfg.vocab_size)
    draws = ts.sample_draws(tcfg, 1, cfg.latent_size, torch.Generator().manual_seed(SEED + 3))

    def run(pipe, blip):
        trainable = ts.partition_params(pipe, tune_text_encoder=True, full_finetuning=True)
        dev = pipe.device
        d = draws._replace(latents0=draws.latents0.to(dev), step_noise=draws.step_noise.to(dev))
        loss, (metrics, _) = ts.make_loss_fn(pipe, blip, tcfg)(batch, d)
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in trainable.items() if p.grad is not None}
        return ({k: float(v) for k, v in metrics.items()}, grads,
                sorted(n for n, p in trainable.items() if p.grad is None))

    t0 = time.perf_counter()
    metrics_cpu, grads_cpu, none_cpu = run(cpu, blip_cpu)
    t_cpu = time.perf_counter() - t0
    del cpu, blip_cpu
    reset(kernels)
    t0 = time.perf_counter()
    metrics_gpu, grads_gpu, none_gpu = run(gpu, blip_gpu)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    counts = counts_by_role(fa, cv)
    rels, zero_leaves = _leaf_rels(grads_gpu, grads_cpu)
    worst_name = max(rels, key=rels.get)
    groups = {"UNet base": lambda n: n.startswith("unet.") and "lora_" not in n,
              "UNet LoRA": lambda n: n.startswith("unet.") and "lora_" in n,
              "text LoRA": lambda n: n.startswith("text.") and "lora_" in n,
              "CLIP-L": lambda n: n.startswith("text.") and "lora_" not in n}
    per_group = {k: (sum(f(n) for n in grads_cpu),
                     max((r for n, r in rels.items() if f(n)), default=0.0))
                 for k, f in groups.items()}
    diffs = {k: abs(metrics_gpu[k] - metrics_cpu[k]) for k in metrics_cpu}
    log(f"  card {metrics_gpu}")
    log(f"  CPU  {metrics_cpu}")
    log(f"  |card - CPU| {diffs}; {len(grads_cpu)} gradient leaves, worst relative "
        f"{rels[worst_name]:.3e} at {worst_name} (cpu {t_cpu:.1f} s, card {t_gpu:.1f} s)")
    log("  leaves and worst relative by group: " + ", ".join(
        f"{k} {n} {w:.3e}" for k, (n, w) in per_group.items()))
    log(f"  without gradient (card, CPU): {none_gpu}, {none_cpu}; zero-gradient leaves, "
        f"largest |g| over the largest gradient: {zero_leaves}")
    log(f"  launches {counts} (predicted {SURF_PARITY_LAUNCHES})")
    if not all(math.isfinite(metrics_gpu[k]) and diffs[k] <= LOSS_TOL for k in diffs):
        raise AssertionError(f"surfaces loss components card vs CPU differ: {diffs}")
    if not rels[worst_name] <= GRAD_TOL:
        raise AssertionError(f"gradient {worst_name} differs by {rels[worst_name]:.3e}")
    if not all(r <= ZERO_LEAF_TOL for r in zero_leaves.values()):
        raise AssertionError(f"zero-gradient leaves are not at noise level: {zero_leaves}")
    if none_gpu != none_cpu or not all(n for n, _ in per_group.values()):
        raise AssertionError(f"surfaces without gradient: {none_gpu} / {none_cpu}")
    if counts != SURF_PARITY_LAUNCHES:
        raise AssertionError(f"surfaces parity launched {counts}")
    del gpu, blip_gpu, grads_gpu, grads_cpu
    gc.collect()
    torch.cuda.empty_cache()


def _state_diffs(torch, a, b):
    """max |delta| of every tensor of two checkpoints' state.pt payloads
    (the trainables, the optimizers' masters and AdamW states, 8-bit codes
    and scales included), by name."""
    diffs = {}
    for key in ("trainable", "d_trainable"):
        for n in a[key]:
            diffs[f"{key}.{n}"] = (a[key][n].float() - b[key][n].float()).abs().max().item()
    for key in ("optimizer", "d_optimizer"):
        for n, m in a[key]["masters"].items():
            diffs[f"{key}.masters.{n}"] = (m - b[key]["masters"][n]).abs().max().item()
        sa, sb = a[key]["adam"]["state"], b[key]["adam"]["state"]
        for i in sa:
            for m in sa[i]:
                if torch.is_tensor(sa[i][m]):
                    diffs[f"{key}.{i}.{m}"] = (sa[i][m].float()
                                               - sb[i][m].float()).abs().max().item()
                elif sa[i][m] != sb[i][m]:
                    diffs[f"{key}.{i}.{m}"] = float("inf")
    return diffs


def phase_surfaces_trainer(torch, fa, cv, kernels, index, cli_median, cli_peak):
    """16(b, c): the trainer CLI on comat_tpu_torch/scripts/sd15.sh's flags
    with every trainable surface and 8-bit AdamW, SURF_STEPS steps with
    validation and a checkpoint at 0, SURF_RESUME and the end, against
    phase 9's latent store; then a run resumed from checkpoint-SURF_RESUME.
    Returns the launches by kernel and shape of both runs."""
    from comat_tpu_torch.models import hf_import
    from comat_tpu_torch.models.pipeline import DiffusionPipeline
    from comat_tpu_torch.training import train_step as ts
    from comat_tpu_torch.training.arguments import launcher_argv, parse_args
    from comat_tpu_torch.training.optim8bit import AdamW8bit
    from comat_tpu_torch.training.trainer import Trainer

    work = os.path.join(REPO, "build", "chip_smoke", "surfaces")   # build/ is ignored
    shutil.rmtree(work, ignore_errors=True)
    argv = launcher_argv(os.path.join(REPO, SD15_LAUNCHER))
    i = argv.index("--training_prompts") + 1
    argv[i] = os.path.join(REPO, argv[i])
    out = os.path.join(work, "output")
    argv += ["--gan_gt_path", index, "--num_validation_images", "1",
             "--max_train_steps", str(SURF_STEPS), "--validation_steps", str(SURF_RESUME),
             "--checkpoints_total_limit", "2", *SURFACE_FLAGS]
    n_val = 3   # validations at step 0, SURF_RESUME and SURF_STEPS
    log("  argv: " + " ".join(argv))
    probe = lambda: counts_by_role(fa, cv)  # noqa: E731
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    reset(kernels)
    t0 = time.perf_counter()
    trainer = Trainer(parse_args(argv + ["--output_dir", out]), probe=probe)
    opt = trainer.state.optimizer
    g_ids = {id(p) for p in trainer.pipeline.unet.parameters()}
    d_base = {n: p for n, p in trainer.disc.unet.named_parameters() if "lora_" not in n}
    d_base0 = {n: p.detach().to("cpu", copy=True) for n, p in d_base.items()}
    g_base0 = {n: m.detach().to("cpu", copy=True) for n, m in opt.masters.items()
               if n.startswith("unet.") and "lora_" not in n}
    surfaces = {t: sum(n.startswith(t + ".") for n in trainer.state.trainable)
                for t in ("unet", "text")}
    log(f"  trainable tensors {surfaces} ({sum(p.numel() for p in trainer.state.trainable.values()) / 1e6:.1f} M"
        f"), text LoRA rank {trainer.pcfg.text_lora_rank}, {len(d_base)} D base tensors "
        f"of their own: {not any(id(p) in g_ids for p in d_base.values())}")
    trainer.train()
    trainer.metrics.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = counts_by_role(fa, cv)
    roles = _cli_roles(trainer)
    int8_bytes = opt.adam.state_bytes()
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    keys = ("s_step", *ts.PHASES)
    for r in rows:
        log(f"  step {r['step']}: loss {r['step_loss']:.4f}, G_loss {r['G_loss']:.4f}, "
            f"D_loss {r['D_loss']:.4f}, grad_norm {r['grad_norm']:.4e}; "
            f"{r['sec_per_step']:.3f} s wall; " + ", ".join(f"{k} {r[k]:.3f}" for k in keys))
    median = _median(rows[1:], ("sec_per_step",) + keys)
    log(f"  surfaces_trainer: {median['s_step']:.3f} s per step on the device "
        f"({median['sec_per_step']:.3f} s wall, median of steps 2-{SURF_STEPS}), s_optimizer "
        f"{median['s_optimizer']:.3f} s, peak memory {peak:.1f} GiB ({peak - held:.2f} above "
        f"the {held:.2f} GiB held before), run {wall:.1f} s ({n_val} validations and "
        f"checkpoints); 8-bit AdamW state {int8_bytes / 2 ** 30:.3f} GiB "
        f"({isinstance(opt.adam, AdamW8bit)}); phase 9, same run: "
        f"{cli_median['s_step']:.3f} s, s_optimizer {cli_median['s_optimizer']:.3f} s, "
        f"{cli_peak:.1f} GiB")
    log("  split: " + ", ".join(f"{k} {median[k]:.3f} s" for k in ts.PHASES))
    want_roles = {role: {k: n * SURF_STEPS for k, n in c.items()}
                  for role, c in CLI_LAUNCHES.items()}
    for role in FULL_ROLES:
        log(f"  launches by role, {SURF_STEPS} steps: {role} {roles[role]} (predicted "
            f"{want_roles[role]})")
    want = {k: sum(c.get(k, 0) for c in want_roles.values())
            + n_val * VALIDATION_LAUNCHES.get(k, 0) for k in counts}
    log(f"  launches in all {counts}, predicted {want}")
    d_same = all(torch.equal(d_base[n].detach().cpu(), v) and d_base[n].grad is None
                 for n, v in d_base0.items())
    g_moved = sum(not torch.equal(opt.masters[n].detach().cpu(), v) for n, v in g_base0.items())
    log(f"  D's base after {SURF_STEPS} G updates equal to its initial values, no gradient: "
        f"{d_same}; G's base masters moved: {g_moved} of {len(g_base0)}")
    if len(rows) != SURF_STEPS or not all(
            math.isfinite(r[k]) for r in rows for k in ("step_loss", "G_loss", "D_loss",
                                                        "grad_norm")):
        raise AssertionError(f"surfaces trainer metrics: {rows}")
    if roles != want_roles or counts != want:
        raise AssertionError(f"surfaces trainer launched {counts} ({roles}), expected "
                             f"{want} ({want_roles})")
    if not (d_same and g_moved > len(g_base0) // 2 and isinstance(opt.adam, AdamW8bit)
            and trainer.pcfg.text_lora_rank == trainer.args.lora_rank):
        raise AssertionError("D's base moved, G's did not, or a surface is missing")
    shapes = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
    pcfg = trainer.pcfg
    del trainer, opt, d_base, d_base0, g_base0
    gc.collect()
    torch.cuda.empty_cache()

    # the exported file into a fresh pipeline: every tensor it holds lands
    last = os.path.join(out, f"checkpoint-{SURF_STEPS}")
    lora_file = os.path.join(last, "pytorch_lora_weights.safetensors")
    fresh = DiffusionPipeline(pcfg, device="cuda", seed=SEED + 5, fuse_pass1=False)
    reports = hf_import.load_lora_state(lora_file, fresh)
    bad = {t: (r.missing[:3], r.unused[:3]) for t, r in reports.items()
           if r.missing or r.unused}
    log(f"  {os.path.basename(lora_file)} ({os.path.getsize(lora_file) / 1e9:.3f} GB) into a "
        f"fresh pipeline: " + ", ".join(f"{t} {r.nbytes / 1e9:.3f} GB" for t, r in
                                        reports.items()) + f"; missing or unused: {bad}")
    if bad or set(reports) != {"unet", "text"}:
        raise AssertionError(f"the export does not load cleanly: {bad}")
    del fresh, reports
    gc.collect()
    torch.cuda.empty_cache()

    # resume from checkpoint-SURF_RESUME, named by path, into a directory of
    # its own: step SURF_STEPS against the uninterrupted run's, bit for bit
    res_out = os.path.join(work, "resumed")
    mid = os.path.join(out, f"checkpoint-{SURF_RESUME}")
    reset(kernels)
    resumed = Trainer(parse_args(argv + ["--output_dir", res_out,
                                         "--resume_from_checkpoint", mid]), probe=probe)
    if resumed.global_step != SURF_RESUME:
        raise AssertionError(f"resumed at step {resumed.global_step}")
    resumed.train()
    resumed.metrics.close()
    torch.cuda.synchronize()
    for kern in kernels:
        acc = shapes.setdefault(kern.symbol, {})
        for key, n in kern.launches_by_shape.items():
            acc[key] = acc.get(key, 0) + n
    row = json.loads(open(os.path.join(res_out, "metrics.jsonl")).read().splitlines()[-1])
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    a = torch.load(os.path.join(last, "state.pt"), weights_only=True)
    b = torch.load(os.path.join(res_out, f"checkpoint-{SURF_STEPS}", "state.pt"),
                   weights_only=True)
    diffs = _state_diffs(torch, a, b)
    worst = max(diffs, key=diffs.get)
    codes = sum(1 for k in diffs if k.endswith(("mu_q", "nu_q")))
    equal = (max(diffs.values()) == 0.0 and torch.equal(a["generator"], b["generator"])
             and a["extra"] == b["extra"] and row["step_loss"] == rows[-1]["step_loss"])
    log(f"  resumed step {row['step']}: loss {row['step_loss']:.4f} (uninterrupted "
        f"{rows[-1]['step_loss']:.4f}); checkpoint-{SURF_STEPS} against the uninterrupted "
        f"run's: {len(diffs)} tensors ({codes} int8 code tensors), largest |delta| "
        f"{diffs[worst]:.3e} ({worst}); equal: {equal}")
    if not equal or row["step"] != SURF_STEPS or not codes:
        raise AssertionError("the resumed run's step does not repeat the uninterrupted run's")
    del a, b
    shutil.rmtree(work, ignore_errors=True)
    return shapes, median, peak


def phase_sdxl_surfaces(torch, fa, cv, kernels, index, sdxl_median, sdxl_peak):
    """17: the SDXL trainer on comat_tpu_torch/scripts/sdxl.sh's flags with
    every trainable surface and 8-bit AdamW, SXS_STEPS steps of
    `Trainer.train_one` (no checkpoint: one would write ~36 GB), at the
    largest of SXS_BATCHES that fits, against phase 12's latent store.
    Returns (launches by kernel and shape, the batch that ran)."""
    from comat_tpu_torch.training import train_step as ts
    from comat_tpu_torch.training.arguments import launcher_argv, parse_args
    from comat_tpu_torch.training.trainer import Trainer

    work = os.path.join(REPO, "build", "chip_smoke", "sdxl_surfaces")   # build/ is ignored
    shutil.rmtree(work, ignore_errors=True)
    argv = launcher_argv(os.path.join(REPO, SDXL_LAUNCHER))
    i = argv.index("--training_prompts") + 1
    argv[i] = os.path.join(REPO, argv[i])
    argv += ["--gan_gt_path", index, "--max_train_steps", str(SXS_STEPS),
             "--output_dir", os.path.join(work, "output"), *SURFACE_FLAGS]
    probe = lambda: counts_by_role(fa, cv)  # noqa: E731
    for batch in SXS_BATCHES:
        bargv = argv + ["--train_batch_size", str(batch)]
        log(f"  argv: {' '.join(bargv)}")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        trainer = opt = rows = None
        try:
            trainer = Trainer(parse_args(bargv), probe=probe)
            opt = trainer.state.optimizer
            masters0 = {n: m.detach().to("cpu", copy=True) for n, m in opt.masters.items()}
            n_params = sum(m.numel() for m in masters0.values())
            log(f"  {len(masters0)} trainable tensors, {n_params / 1e9:.3f} G parameters: "
                + ", ".join(f"{t} {sum(n.startswith(t + '.') for n in masters0)}"
                            for t in ("unet", "text", "text2")) + f"; {_gib(torch)}")
            prompts = iter(trainer.dataset.epoch(0))
            rows = [trainer.train_one(next(prompts))]
            proj = opt.masters["text2.text_projection.weight"].grad
            proj_ok = bool(proj is not None and torch.isfinite(proj).all()
                           and proj.abs().max() > 0)
            moved = [n for n, m in opt.masters.items()
                     if not torch.equal(m.detach().cpu(), masters0[n])]
            still = sorted(set(masters0) - set(moved))
            # a tensor no gradient reaches and that holds zeros stays: AdamW
            # moves it by lr * wd * 0 (SDXL reads CLIP-L's penultimate
            # states, so its last layer's zero biases and LoRA-B)
            unreached = {n for n in still if not masters0[n].any() and (
                opt.masters[n].grad is None or not opt.masters[n].grad.any())}
            del masters0
            for _ in range(SXS_STEPS - 1):
                rows.append(trainer.train_one(next(prompts)))
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"  batch {batch} does not fit: {str(e).splitlines()[0]}")
            trainer = opt = None
            if batch == SXS_BATCHES[-1]:
                raise
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = counts_by_role(fa, cv)
    roles = _cli_roles(trainer)
    int8_bytes = opt.adam.state_bytes()
    keys = ("s_step", *ts.PHASES)
    for n, r in enumerate(rows, 1):
        log(f"  step {n}: loss {r['step_loss']:.4f}, G_loss {r['G_loss']:.4f}, D_loss "
            f"{r['D_loss']:.4f}, grad_norm {r['grad_norm']:.4e}; "
            + ", ".join(f"{k} {r[k]:.3f}" for k in keys))
    last = rows[-1]
    log(f"  sdxl_surfaces at batch {batch}: {last['s_step']:.3f} s per step on the device "
        f"(step {len(rows)}), s_optimizer {last['s_optimizer']:.3f} s, peak memory "
        f"{peak:.1f} GiB, 8-bit AdamW state {int8_bytes / 2 ** 30:.3f} GiB; phase 12, same "
        f"run: {sdxl_median['s_step']:.3f} s, s_optimizer {sdxl_median['s_optimizer']:.3f} s, "
        f"{sdxl_peak:.1f} GiB")
    log(f"  text2.text_projection's gradient after step 1 finite and nonzero: {proj_ok}; "
        f"masters moved by step 1: {len(moved)} of {len(moved) + len(still)}; unmoved, "
        f"zero and without gradient: {sorted(unreached)}; other unmoved: "
        f"{sorted(set(still) - unreached)}")
    want_roles = {role: {k: n * SXS_STEPS for k, n in c.items()}
                  for role, c in SDXL_CLI_LAUNCHES.items()}
    scale = batch / SDXL_BATCH
    log(f"  launches by role, {SXS_STEPS} steps: {roles} (predicted at batch "
        f"{SDXL_BATCH}: {want_roles}); in all {counts}")
    if not all(math.isfinite(r[k]) for r in rows for k in ("step_loss", "G_loss", "D_loss",
                                                           "grad_norm")):
        raise AssertionError(f"SDXL surfaces metrics: {rows}")
    if not proj_ok or set(still) - unreached:
        raise AssertionError(f"pooled-embed gradient {proj_ok}, unmoved tensors "
                             f"{sorted(set(still) - unreached)[:5]}")
    if scale == 1 and roles != want_roles:
        raise AssertionError(f"SDXL surfaces launched {roles}, expected {want_roles}")
    shapes = ({kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
              if batch == SDXL_BATCH else {})
    del trainer, opt
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return shapes, batch


# ------------------------------------------------------ W8A8 pass 1 (18-20)
# W8A8 pass 1 (--pass1_int8): the kernels of ops/quant.py, which replace no
# Pallas kernel (JAX runs W8A8 through XLA, comat_tpu/models/quant.py)
INT8_REPLACES = {
    "quant_s8": "none (XLA in JAX): comat_tpu/models/quant.py:43 _quant_dynamic, "
                ":157 _weight_quant",
    "dequant_s8": "none (XLA in JAX): comat_tpu/models/quant.py:54 _dequant_bias "
                  "after :72 dot_general",
    "conv_s8": "none (XLA in JAX): comat_tpu/models/quant.py:130 conv_general_dilated "
               "and :54 _dequant_bias",
}
INT8_BATCHES = {"sd15": 4, "sdxl": SDXL_BATCH}     # phase 19's; CFG doubles them
INT8_COS = 0.99          # JAX's gate, tests/test_quant.py: int8 against bf16
INT8_STEPS = 2
INT8_TIME_BUDGET_MS = 60.0
STABILITY_STEPS = 6
N_PHASES = 24


def int8_counts(oq):
    """Launches of the int8 kernels since the last reset, by role."""
    q = oq.QUANT_KERNEL.launches_by_shape
    return {"quant_act": sum(n for k, n in q.items() if k[-1] == "act"),
            "quant_weight": sum(n for k, n in q.items() if k[-1] == "weight"),
            "dequant": oq.DEQUANT_KERNEL.launches, "conv_s8": oq.CONV_KERNEL.launches}


def _int8_pipelines(torch):
    """SD1.5 and SDXL at published widths, bf16, LoRA 128 (the launchers'
    rank), seeded: {"sd15": pipeline, "sdxl": pipeline}."""
    from comat_tpu_torch.models.pipeline import DiffusionPipeline, make_pipeline_config

    out = {}
    for key, name in (("sd15", "sd_1_5"), ("sdxl", "sdxl")):
        t0 = time.perf_counter()
        cfg = make_pipeline_config(name, lora_rank=128, resolution=512)
        pipe = DiffusionPipeline(cfg, device="cuda", seed=SEED + 21)
        _nonzero_lora_b(torch, pipe.unet, torch.Generator().manual_seed(SEED + 22))
        out[key] = pipe
        torch.cuda.synchronize()
        log(f"  {key}: weights made in {time.perf_counter() - t0:.1f} s; {_gib(torch)}")
    return out


def _prompt_ids(pipe, n):
    from comat_tpu_torch.text.tokenizer import HashTokenizer

    prompts = (TRAIN_PROMPTS * n)[:n]
    V = pipe.cfg.text.vocab_size
    tok = HashTokenizer(V)
    enc, null = tok(prompts), tok([""] * n)
    kw = {"eos_positions": enc["eos_positions"]}
    if pipe.cfg.is_sdxl:
        tok2 = HashTokenizer(V, pad_token_id=0)
        kw.update(input_ids2=tok2(prompts)["input_ids"], null_ids2=tok2([""] * n)["input_ids"])
    return enc["input_ids"], null["input_ids"], kw


def _int8_layer_inputs(torch, unet, call):
    """(name, layer, input) of every quantized layer in its first use during
    `call()`, the bf16 UNet's own (no int8 set installed)."""
    from comat_tpu_torch.models.quant import QConv2d, QLinear, quantizable

    seen, hooks = {}, []
    for name, m in unet.named_modules():
        if isinstance(m, (QLinear, QConv2d)) and quantizable(name):
            def pre(mod, args, name=name):
                seen.setdefault(name, (mod, args[0].detach()))
            hooks.append(m.register_forward_pre_hook(pre))
    try:
        with torch.no_grad():
            call()
    finally:
        for h in hooks:
            h.remove()
    return [(n, m, x) for n, (m, x) in seen.items()]


def _exact(torch, name, got, want) -> None:
    """Raise unless the kernel's output equals the plain version's, bit for bit."""
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        d = (got.double() - want.double()).abs()
        raise AssertionError(f"{name}: kernel and plain version differ ({int((d > 0).sum())} "
                             f"elements, max {float(d.max()):.3e})")


def phase_int8_kernels(torch, oq, pipes):
    """18: every distinct quantized layer of SD1.5 at 512^2 (CFG batch 8)
    and SDXL (CFG batch 12), the layer's real bf16 input and weight from one
    guided UNet call of the seeded pipelines: the quantize kernel's codes and
    scales (activations and weights), the int8 conv's int32 sums and its
    bf16 epilogue, the dequantize after `torch._int_mm`, each equal to its
    plain version bit for bit; times against the plain versions and the
    yardsticks (bf16 cuDNN `F.conv2d` / `F.linear`, `torch._int_mm` with the
    plain dequantize; the conv kernel as a 1x1 conv over the linear's rows
    too). Returns the kernels line's entries."""
    import torch.nn.functional as F

    from comat_tpu_torch.models.quant import QConv2d, weight_quant

    src = {"quant_s8": "comat_tpu_torch/csrc/quant_s8.cu",
           "conv_s8": "comat_tpu_torch/csrc/conv_s8.cu"}
    entries, done = [], set()

    def tm(fn):
        return time_ms(torch, fn, INT8_TIME_BUDGET_MS)

    def add(e):
        if (e["kernel"], tuple(e["key"])) not in done:
            done.add((e["kernel"], tuple(e["key"])))
            entries.append(e)
            _log_entry(e)

    def check_quant(x2, groups, role):
        key = (groups, x2.numel() // groups, "bfloat16", role)
        if (oq.QUANT_KERNEL.symbol, key) in done:
            return
        q, s = oq.quantize(x2, groups, role)
        q_ref, s_ref = oq.quantize_ref(x2, groups)
        _exact(torch, f"quantize {key}", q, q_ref)
        _exact(torch, f"quantize scales {key}", s, s_ref)
        times = (tm(lambda: oq.quantize(x2, groups, role)),
                 tm(lambda: oq.quantize_ref(x2, groups)), None)
        n = x2.numel()
        add(_entry("quant_s8", src["quant_s8"], INT8_REPLACES["quant_s8"],
                   oq.QUANT_KERNEL.symbol, key, key[:2], "bfloat16", 0.0, times, 4.0 * n,
                   2 * n + n + 4 * groups, "none", ops_dtype="float32", role=role))

    for model, pipe in pipes.items():
        B = 2 * INT8_BATCHES[model]
        unet = pipe.fused_unet()
        ids, null, kw = _prompt_ids(pipe, INT8_BATCHES[model])
        enc, nenc, added, null_added = pipe._encode_pair(
            ids, null, kw["eos_positions"], None, kw.get("input_ids2"), kw.get("null_ids2"))
        eps = pipe._pass1_eps_model(enc.context, nenc.context, 7.5, 0.0, unet, added,
                                    null_added)
        s = pipe.cfg.latent_size
        lat = torch.randn(B // 2, s, s, 4, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(SEED + 23))
        layers = _int8_layer_inputs(torch, unet, lambda: eps(lat, 981))
        n_conv = sum(isinstance(m, QConv2d) for _, m, _ in layers)
        log(f"  {model}: {len(layers)} quantized layers ({n_conv} conv), CFG batch {B}")
        for name, layer, x in layers:
            w = layer.weight.detach()
            wq, ws = weight_quant(w)
            w2 = w if w.dim() == 2 else w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
            check_quant(w2.contiguous(), w2.shape[0], "weight")
            bias = None if layer.bias is None else layer.bias.detach().float()
            N = w.shape[0]
            if isinstance(layer, QConv2d):
                ks, st, pd = layer.kernel_size[0], layer.stride[0], layer.padding[0]
                xn = x.permute(0, 2, 3, 1).contiguous()
                check_quant(xn, xn.shape[0], "act")
                xq, sx = oq.quantize_ref(xn, xn.shape[0])
                Bx, H, W, C = xn.shape
                key = (Bx, H, W, C, N, ks, st, "bfloat16")
                if (oq.CONV_KERNEL.symbol, key) in done:
                    continue
                acc = oq.conv_s8(xq, wq, ks, st, pd, torch.int32)
                acc_ref = oq.conv_s8_ref(xq, wq, ks, st, pd)
                _exact(torch, f"conv_s8 sums {key}", acc, acc_ref)
                Ho, Wo = acc.shape[1:3]
                y = oq.conv_s8(xq, wq, ks, st, pd, torch.bfloat16, sx, ws, bias)
                y_ref = oq.dequant_ref(acc_ref.reshape(-1, N), sx, Ho * Wo, ws, bias,
                                       torch.bfloat16).reshape(y.shape)
                _exact(torch, f"conv_s8 bf16 {key}", y, y_ref)
                M = Bx * Ho * Wo
                times = (tm(lambda: oq.conv_s8(xq, wq, ks, st, pd, torch.bfloat16, sx, ws,
                                               bias)),
                         tm(lambda: oq.dequant_ref(oq.conv_s8_ref(xq, wq, ks, st, pd)
                                                   .reshape(-1, N), sx, Ho * Wo, ws, bias,
                                                   torch.bfloat16)),
                         tm(lambda: F.conv2d(x, w, layer.bias, st, pd)))
                add(_entry("conv_s8", src["conv_s8"], INT8_REPLACES["conv_s8"],
                           oq.CONV_KERNEL.symbol, key, key[:7], "bfloat16", 0.0, times,
                           2.0 * M * N * ks * ks * C,
                           xn.numel() + wq.numel() + 4 * (Bx + 2 * N) + 2 * M * N,
                           "F.conv2d bf16 (cuDNN)", ops_dtype="int8", layer=name))
            else:
                K = x.shape[-1]
                x2 = x.reshape(-1, K).contiguous()
                M = x2.shape[0]
                check_quant(x2, M, "act")
                key = (M, N, "bfloat16")
                if (oq.DEQUANT_KERNEL.symbol, key) in done:
                    continue
                xq, sx = oq.quantize_ref(x2, M)
                acc = torch._int_mm(xq, wq.t())
                acc_ref = (xq.double() @ wq.double().t()).round().to(torch.int32)
                _exact(torch, f"_int_mm sums {key}", acc, acc_ref)
                y = oq.dequant(acc, sx, 1, ws, bias, torch.bfloat16)
                _exact(torch, f"dequant {key}", y, oq.dequant_ref(acc, sx, 1, ws, bias,
                                                           torch.bfloat16))
                # the other route: the conv kernel as a 1x1 conv over the M rows
                # with its epilogue (timed only: one scale for all rows)
                x4, sx1 = xq.reshape(1, M, 1, K), sx[:1].contiguous()
                t_conv = tm(lambda: oq.conv_s8(x4, wq, 1, 1, 0, torch.bfloat16, sx1, ws, bias))
                t_mm = tm(lambda: torch._int_mm(xq, wq.t()))
                times = (tm(lambda: oq.dequant(acc, sx, 1, ws, bias, torch.bfloat16)),
                         tm(lambda: oq.dequant_ref(acc, sx, 1, ws, bias, torch.bfloat16)),
                         tm(lambda: oq.dequant_ref(torch._int_mm(xq, wq.t()), sx, 1, ws,
                                                   bias, torch.bfloat16)))
                add(_entry("dequant_s8", src["quant_s8"], INT8_REPLACES["dequant_s8"],
                           oq.DEQUANT_KERNEL.symbol, key, key[:2], "bfloat16", 0.0, times,
                           3.0 * M * N, 4 * M * N + 2 * M * N + 4 * (M + 2 * N),
                           "torch._int_mm + plain dequantize", ops_dtype="float32",
                           layer=name, K=K, int_mm_ms=t_mm, conv_s8_1x1_ms=t_conv,
                           linear_bf16_ms=tm(lambda: F.linear(x2, w, layer.bias)),
                           gemm_bound_ms=bound_ms(2.0 * M * N * K, M * K + N * K + 4 * M * N,
                                                  "int8")[0]))
        del layers
        torch.cuda.empty_cache()
    return entries


def phase_int8_pass1(torch, kernels, oq, pipes):
    """19(a): pass 1 alone, 50 guided DDPM calls through the fused twin, bf16
    and W8A8 from the same draws, in turns (bf16, int8, int8, bf16): SD1.5
    at batch 4 and SDXL at batch 6 (CFG 8 and 12). Returns {model: launches
    by kernel and shape of one int8 run}."""
    from comat_tpu_torch.models.quant import QConv2d, quantize_unet

    shapes = {}
    for model, pipe in pipes.items():
        n = INT8_BATCHES[model]
        unet = pipe.fused_unet()
        ids, null, kw = _prompt_ids(pipe, n)
        s = pipe.cfg.latent_size
        g = torch.Generator(device="cuda").manual_seed(SEED + 24)
        lat0 = torch.randn(n, s, s, 4, generator=g, device="cuda")
        noise = torch.randn(50, n, s, s, 4, generator=g, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        weights = quantize_unet(unet)
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        n_layers = len(weights)
        nbytes = sum(t.numel() * t.element_size() for w in weights.values()
                     for t in w if t is not None)
        n_conv = sum(isinstance(unet.get_submodule(k), QConv2d) for k in weights)
        del weights
        runs, out = [], {}
        for int8 in (False, True, True, False):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            if int8 and int8 not in out:
                reset(kernels)
            t0 = time.perf_counter()
            lat = pipe.generate(ids, null, num_inference_steps=50, output_type="latent",
                                latents0=lat0, step_noise=noise, unet=unet, int8=int8, **kw)
            torch.cuda.synchronize()
            runs.append((int8, time.perf_counter() - t0,
                         (torch.cuda.max_memory_allocated() - held) / 2 ** 30))
            if int8 not in out:
                out[int8] = lat.float()
                if int8:
                    counts = {**int8_counts(oq), "flash_fwd": kernels[0].launches}
                    shapes[model] = {k.symbol: dict(k.launches_by_shape) for k in kernels}
        a, b = out[False].double().flatten(), out[True].double().flatten()
        cos = float(a @ b / (a.norm() * b.norm()))
        t_bf = [t for i8, t, _ in runs if not i8]
        t_i8 = [t for i8, t, _ in runs if i8]
        log(f"  {model} pass 1, batch {n} (CFG {2 * n}), 50 guided calls: bf16 "
            f"{t_bf[0]:.3f} / {t_bf[1]:.3f} s, int8 {t_i8[0]:.3f} / {t_i8[1]:.3f} s "
            f"(int8 / bf16 {sum(t_i8) / sum(t_bf):.3f}); peak above the weights held: "
            + ", ".join(f"{'int8' if i8 else 'bf16'} {gib:.2f} GiB" for i8, _, gib in runs))
        log(f"  {model} int8 weight set: {n_layers} layers ({n_conv} conv), "
            f"{nbytes / 1e9:.3f} GB, quantized in {t_quant:.3f} s; cos of the final "
            f"latents int8 vs bf16 {cos:.6f} (gate > {INT8_COS}); launches of one int8 "
            f"run {counts}")
        want = {"quant_act": 50 * n_layers, "quant_weight": n_layers,
                "dequant": 50 * (n_layers - n_conv), "conv_s8": 50 * n_conv}
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"{model} int8 pass 1 launched {counts}, expected {want}")
        if not (torch.isfinite(out[True]).all() and cos > INT8_COS):
            raise AssertionError(f"{model} int8 pass 1: cos {cos:.6f} against bf16")
    return shapes


def phase_int8_trainer(torch, fa, cv, oq, kernels, cli_argv, cli_step1, cli_median,
                       cli_peak):
    """19(b): the trainer on comat_tpu_torch/scripts/sd15.sh's flags (phase
    9's run, Grounded-SAM's split step) with --pass1_int8, INT8_STEPS steps
    of `Trainer.train_one` from the same seed and draws. Returns the
    launches by kernel and shape."""
    from comat_tpu_torch.models.quant import QConv2d, QLinear, quantizable
    from comat_tpu_torch.training import train_step as ts
    from comat_tpu_torch.training.arguments import parse_args
    from comat_tpu_torch.training.trainer import Trainer

    work = os.path.join(REPO, "build", "chip_smoke", "int8_trainer")   # build/ is ignored
    shutil.rmtree(work, ignore_errors=True)
    argv = list(cli_argv) + ["--output_dir", work, "--max_train_steps", str(INT8_STEPS),
                             "--pass1_int8"]
    log("  argv: " + " ".join(argv))
    probe = lambda: {**counts_by_role(fa, cv), **int8_counts(oq)}  # noqa: E731
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    trainer = Trainer(parse_args(argv), probe=probe)
    assert trainer.tcfg.pass1_int8 and trainer.tcfg.gradient_checkpointing
    kinds = [isinstance(m, QConv2d) for n, m in trainer.pipeline.unet.named_modules()
             if isinstance(m, (QLinear, QConv2d)) and quantizable(n)]
    prompts = iter(trainer.dataset.epoch(0))
    rows = [trainer.train_one(next(prompts)) for _ in range(INT8_STEPS)]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    roles = _cli_roles(trainer)
    keys = ("s_step", *ts.PHASES)
    for i, r in enumerate(rows, 1):
        log(f"  step {i}: loss {r['step_loss']:.4f}, G_loss {r['G_loss']:.4f}, grad_norm "
            f"{r['grad_norm']:.4e}; " + ", ".join(f"{k} {r[k]:.3f}" for k in keys))
    median = _median(rows[1:], keys)
    log(f"  int8 trainer: {median['s_step']:.3f} s per step on the device (median of steps "
        f"2-{INT8_STEPS}), pass 1 {median['s_pass1']:.3f} s; phase 9, same run: "
        f"{cli_median['s_step']:.3f} s, pass 1 {cli_median['s_pass1']:.3f} s; peak memory "
        f"{peak:.1f} GiB (phase 9 {cli_peak:.1f}); step-1 loss {rows[0]['step_loss']:.6f}, "
        f"phase 9's bf16 step 1 from the same draws {cli_step1:.6f} (|delta| "
        f"{abs(rows[0]['step_loss'] - cli_step1):.3e})")
    log("  split: " + ", ".join(f"{k} {median[k]:.3f} (phase 9 {cli_median[k]:.3f})"
                                for k in ts.PHASES))
    L, Lc = len(kinds), sum(kinds)
    per_step = {"quant_act": 50 * L, "quant_weight": L, "dequant": 50 * (L - Lc),
                "conv_s8": 50 * Lc}
    want_roles = {role: {k: n * INT8_STEPS for k, n in c.items()}
                  for role, c in CLI_LAUNCHES.items()}
    want_roles["pass1"].update({k: n * INT8_STEPS for k, n in per_step.items()})
    log(f"  launches by role, {INT8_STEPS} steps: {roles} (predicted {want_roles})")
    if not all(math.isfinite(r[k]) for r in rows for k in ("step_loss", "G_loss", "D_loss",
                                                           "grad_norm")):
        raise AssertionError(f"int8 trainer metrics: {rows}")
    if roles != want_roles:
        raise AssertionError(f"int8 trainer launched {roles}, expected {want_roles}")
    shapes = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return shapes


def phase_stability(torch, kernels):
    """21: tools/stability_run.py on the card, STABILITY_STEPS steps of
    bench's default step (SD1.5 512^2, batch 4, the reduced recipe).
    Returns the launches by kernel and shape."""
    from comat_tpu_torch.tools import stability_run

    gc.collect()
    torch.cuda.empty_cache()
    reset(kernels)
    rec = stability_run.main(["--steps", str(STABILITY_STEPS)])
    secs = rec["seconds"]
    med = sorted(secs)[len(secs) // 2]
    steady = secs[2:]
    med2 = sorted(steady)[len(steady) // 2]
    log(f"  stability on {rec['device']}: " + ", ".join(f"{x:.3f}" for x in secs)
        + f" s; spread (max - min) / median {(max(secs) - min(secs)) / med:.3f} over all "
        f"steps, {(max(steady) - min(steady)) / med2:.3f} from step 2; steady "
        f"{rec['steady_s']:.3f} s/step, {rec['images_per_s']:.3f} images/s; all finite "
        f"{rec['all_finite']}")
    if len(secs) != STABILITY_STEPS or not rec["all_finite"]:
        raise AssertionError(f"stability run: {rec}")
    return {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}


# ---- phases 22-23: the process group ----

DDP_STEPS = 2
DDP_LOSS_REL = 1e-3      # world 2 against world 1 at twice the batch
DDP_COS, DDP_NORM_REL = 0.999, 0.01
TP_COS, TP_REL = 0.9999, 1e-2


def _group_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(target, world, *args, timeout=900):
    """`target(rank, world, port, out, *args)` in `world` spawned processes
    on this card, joined by a Gloo group; returns their results by rank.
    A rank's exception fails the call; every process is stopped."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _group_port()
    procs = [ctx.Process(target=target, args=(r, world, port, out, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=timeout)
            except queue.Empty:
                raise AssertionError(f"ranks {sorted(set(range(world)) - set(results))} "
                                     f"sent nothing in {timeout} s")
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    return [results[r] for r in range(world)]


def _child(rank, world, port, out, fn, *args):
    """A spawned rank: one card (cuda:0, shared), a Gloo group."""
    import traceback
    from datetime import timedelta

    try:
        import torch
        import torch.distributed as dist

        os.environ["LOCAL_RANK"] = "0"
        sys.path.insert(0, REPO)
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=timedelta(minutes=10))
        try:
            out.put((rank, True, fn(torch, rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def phase_ddp_world1(torch, fa, cv, kernels, cli_argv, cli_steps):
    """22(a): the trainer on sd15.sh's flags (phase 9's argv) for DDP_STEPS
    steps under a world-1 NCCL group: each step's loss, and G's and D's
    trained tensors after the last, equal phase 9's first steps without a
    group bit for bit. Returns the launches by kernel and shape."""
    import torch.distributed as dist

    from comat_tpu_torch.training import train_step as ts
    from comat_tpu_torch.training.arguments import parse_args
    from comat_tpu_torch.training.trainer import Trainer

    work = os.path.join(REPO, "build", "chip_smoke", "ddp_world1")   # build/ is ignored
    shutil.rmtree(work, ignore_errors=True)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_group_port()}",
                            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        gc.collect()
        torch.cuda.empty_cache()
        probe = lambda: counts_by_role(fa, cv)  # noqa: E731
        reset(kernels)
        trainer = Trainer(parse_args(list(cli_argv) + ["--output_dir", work,
                                                        "--max_train_steps",
                                                        str(DDP_STEPS)]), probe=probe)
        mesh = trainer.mesh
        prompts = iter(trainer.dataset.epoch(0))
        rows = [trainer.train_one(next(prompts)) for _ in range(DDP_STEPS)]
        torch.cuda.synchronize()
        shapes = {kern.symbol: dict(kern.launches_by_shape) for kern in kernels}
        roles = _cli_roles(trainer)
        g = {n: p.detach().cpu() for n, p in trainer.state.trainable.items()}
        d = {n: p.detach().cpu() for n, p in trainer.d_state.trainable.items()}
        del trainer
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    keys = ("s_step", *ts.PHASES)
    for i, r in enumerate(rows, 1):
        log(f"  step {i}: loss {r['step_loss']!r} (no group {cli_steps[i - 1]['loss']!r}); "
            f"all-reduced {r['allreduce_bytes'] / 1e6:.1f} MB in s_allreduce "
            f"{r['s_allreduce']:.4f} s; " + ", ".join(f"{k} {r[k]:.3f}" for k in keys))
    ref = cli_steps[DDP_STEPS - 1]
    differ = [f"g.{n}" for n, v in g.items() if not torch.equal(v, ref["g"][n])]
    differ += [f"d.{n}" for n, v in d.items() if not torch.equal(v, ref["d"][n])]
    losses_equal = all(r["step_loss"] == c["loss"] for r, c in zip(rows, cli_steps))
    log(f"  mesh {mesh.data} x {mesh.model} over NCCL; {len(g)} G and {len(d)} D trained "
        f"tensors after step {DDP_STEPS}, {len(differ)} differ from the run without a "
        f"group; losses equal: {losses_equal}; launches by role {roles}")
    want_roles = {role: {k: n * DDP_STEPS for k, n in c.items()}
                  for role, c in CLI_LAUNCHES.items()}
    if differ or not losses_equal or set(g) != set(ref["g"]):
        raise AssertionError(f"world 1 over NCCL is not the run without a group: "
                             f"{differ[:5]}, losses {[r['step_loss'] for r in rows]}")
    if roles != want_roles:
        raise AssertionError(f"world-1 trainer launched {roles}, expected {want_roles}")
    return shapes


def _ddp_rank(torch, rank, argv):
    """22(b) in one rank (or in this process, without a group): the
    trainer on this rank's rows for one step. Returns (its prompts, the
    metrics, G's trained tensors before and after, the peak GiB, the
    step's wall seconds, (data groups, model axis, data index), G's
    all-reduced gradients before the clip), on the host."""
    from comat_tpu_torch.training.arguments import parse_args
    from comat_tpu_torch.training.trainer import Trainer

    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(parse_args(argv))
    before = {n: p.detach().float().cpu().numpy() for n, p in trainer.state.trainable.items()}
    grads = {}
    record_grads(trainer.state.optimizer, grads)
    prompts = next(iter(trainer.dataset.epoch(0)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = trainer.train_one(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = {n: p.detach().float().cpu().numpy() for n, p in trainer.state.trainable.items()}
    mesh = trainer.mesh
    where = (mesh.data, mesh.model, mesh.data_index) if mesh is not None else (1, 1, 0)
    return (prompts, metrics, before, after, torch.cuda.max_memory_allocated() / 2 ** 30,
            wall, where, grads)


def phase_ddp_world2(torch, cli_argv, batch):
    """22(b): two processes on this one card over Gloo, each the trainer
    at --train_batch_size batch // 2 for one step, against one process at
    `batch` from the same seed, in this process. Both on sd15.sh's flags
    (phase 9's argv) with the CenterPrior segmenter: Grounded-SAM's masks
    are no continuous function of the image (its top-900 query selection
    swaps near ties), so two runs whose images differ by bf16 roundoff
    segment differently."""
    import numpy as np

    work = os.path.join(REPO, "build", "chip_smoke", "ddp_world2")   # build/ is ignored
    shutil.rmtree(work, ignore_errors=True)
    common = list(cli_argv) + ["--seg_model", "center_prior", "--max_train_steps", "1"]
    gc.collect()
    torch.cuda.empty_cache()
    ref = _ddp_rank(torch, 0, common + ["--output_dir", os.path.join(work, "w1"),
                                        "--train_batch_size", str(batch)])
    log(f"  one process at batch {batch}: loss {ref[1]['step_loss']!r}, s_step "
        f"{ref[1]['s_step']:.3f} s, wall {ref[5]:.3f} s, peak {ref[4]:.1f} GiB")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = _spawn(_child, 2, _ddp_rank, common + ["--output_dir", os.path.join(work, "w2"),
                                                 "--train_batch_size", str(batch // 2)])
    log(f"  two ranks over Gloo on one card in {time.perf_counter() - t0:.1f} s "
        f"(spawn, build, one step)")
    first = ref[0]
    seen = out[0][0] + out[1][0]
    for rank, (prompts, m, _, _, peak, wall, where, _) in enumerate(out):
        log(f"  rank {rank} (mesh {where[0]} x {where[1]}, data index {where[2]}): prompts "
            f"{prompts}; loss {m['step_loss']!r}, s_step {m['s_step']:.3f} s, s_allreduce "
            f"{m['s_allreduce']:.4f} s for {m['allreduce_bytes'] / 1e6:.1f} MB, wall "
            f"{wall:.3f} s, peak {peak:.1f} GiB (two processes sharing one card: not a "
            f"scaling figure)")
    loss, want = out[0][1]["step_loss"], ref[1]["step_loss"]
    rel = abs(loss - want) / abs(want)
    before, after0, after1 = out[0][2], out[0][3], out[1][3]
    grads0, grads1 = out[0][7], out[1][7]
    same = all(np.array_equal(after0[n], after1[n]) for n in after0) and all(
        np.array_equal(grads0[n], grads1[n]) for n in grads0)

    def worst(pairs):
        """The smallest cos and the largest norm gap over the leaves."""
        low, gap = (1.0, ""), (0.0, "")
        for n, (a, b) in pairs.items():
            a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
            na, nb = np.linalg.norm(a), np.linalg.norm(b)
            low = min(low, (float(a @ b / (na * nb)) if na and nb else float(na == nb), n))
            gap = max(gap, (abs(na - nb) / nb if nb else float(na > 0), n))
        return low, gap

    g_cos, g_gap = worst({n: (g, ref[7][n]) for n, g in grads0.items()})
    u_cos, u_gap = worst({n: (a - before[n], ref[3][n] - before[n]) for n, a in after0.items()})
    log(f"  global loss {loss!r} against one process at batch {batch} {want!r} (relative "
        f"{rel:.3e}, gate {DDP_LOSS_REL}); rows {seen} (one process: {first}); the ranks' "
        f"gradients and tensors equal: {same}; gradient of each of {len(grads0)} LoRA "
        f"leaves (all-reduced, before the clip): worst cos {g_cos[0]:.6f} ({g_cos[1]}), "
        f"worst norm gap {g_gap[0]:.4%} ({g_gap[1]}); update (AdamW's first step, lr "
        f"sign(g) where |g| >> eps: not gated): worst cos {u_cos[0]:.6f} ({u_cos[1]}), "
        f"worst norm gap {u_gap[0]:.4%}")
    if (rel > DDP_LOSS_REL or seen != first or not same or set(grads0) != set(ref[7])
            or g_cos[0] < DDP_COS or g_gap[0] > DDP_NORM_REL):
        raise AssertionError("world 2 does not train as world 1 at twice the batch")
    shutil.rmtree(work, ignore_errors=True)


def _tp_rank(torch, rank):
    """23 in one rank: SD1.5's UNet at full width (fp32, TF32 off, LoRA 128
    with nonzero B) and its copy sharded by `apply_tp` over the two ranks:
    one guided call's eps (batch 2 at 512^2) and the LoRA gradients of a
    fixed weighting of it, on both; kernel A's launches of each by heads
    (its fp32 code: in bf16 the two differ by bf16 roundoff, which the
    narrower GEMMs place elsewhere)."""
    import copy

    import numpy as np

    from comat_tpu_torch.config import UNetConfig
    from comat_tpu_torch.models.unet import UNet2DConditionModel
    from comat_tpu_torch.ops import flash_attention as fa
    from comat_tpu_torch.parallel import mesh as pmesh
    from comat_tpu_torch.parallel import tp as ptp
    from comat_tpu_torch.weights import init_weights_

    mesh = pmesh.make_mesh(data=1, model=2)
    cfg = dataclasses.replace(UNetConfig.sd15(), dtype=torch.float32)
    unet = UNet2DConditionModel(cfg, lora_rank=128, device="cuda")
    with torch.no_grad():
        init_weights_(unet, torch.Generator(device="cuda").manual_seed(SEED + 23))
    _nonzero_lora_b(torch, unet, torch.Generator().manual_seed(SEED + 24))
    ref = copy.deepcopy(unet)
    g = torch.Generator().manual_seed(SEED + 25)
    x = torch.randn((2, 64, 64, 4), generator=g).cuda()
    ctx = torch.randn((2, 77, 768), generator=g).cuda()
    w = torch.randn((2, 64, 64, 4), generator=g).cuda()
    t = torch.tensor([500, 500], device="cuda")

    def run(model):
        fa.KERNEL.reset_counts()
        eps = model(x, t, ctx)
        lora = {n: p for n, p in model.named_parameters() if "lora_" in n}
        grads = torch.autograd.grad((eps.float() * w).sum(), list(lora.values()))
        torch.cuda.synchronize()
        heads = {}
        for key, n in fa.KERNEL.launches_by_shape.items():
            heads[key[0] // 2] = heads.get(key[0] // 2, 0) + n
        return eps.detach().float(), dict(zip(lora, grads)), heads

    e0, g0, h0 = run(ref)
    del ref
    plan = ptp.apply_tp(unet, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e1, g1, h1 = run(unet)
    sharded_s = time.perf_counter() - t0

    def cmp(a, b):
        a, b = a.double().ravel(), b.double().ravel()
        cos = float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))
        return cos, float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    leaves = {n: cmp(ptp.gather_shard(g1[n], plan.get(n), mesh), g0[n]) for n in g0}
    out = {"eps": cmp(e1, e0), "leaves": leaves, "heads_ref": h0, "heads_tp": h1,
           "sharded": len(plan), "seconds": sharded_s,
           "peak": torch.cuda.max_memory_allocated() / 2 ** 30,
           "finite": bool(np.isfinite(e1.cpu().numpy()).all())}
    del unet, e0, e1, g0, g1
    gc.collect()
    torch.cuda.empty_cache()
    out["int8"] = _tp_int8(torch, mesh, x, ctx, t)
    return out


def _tp_int8(torch, mesh, x, ctx, t):
    """23's W8A8 part in one rank: SD1.5's LoRA-free UNet in bf16 (the fused
    pass 1's), unsharded and sharded by `apply_tp`, each quantized by
    `quantize_unet` and run once under its int8 weight set on the same
    inputs. Returns whether the weight codes and scales, the activation
    scales and codes (their slice where a row-parallel layer's input) and
    eps are equal, and the quantize kernel's launches on each."""
    import copy

    import numpy as np

    from comat_tpu_torch.config import UNetConfig
    from comat_tpu_torch.models import quant as mq
    from comat_tpu_torch.models.unet import UNet2DConditionModel
    from comat_tpu_torch.ops import quant as oq
    from comat_tpu_torch.parallel import tp as ptp
    from comat_tpu_torch.weights import init_weights_

    cfg = dataclasses.replace(UNetConfig.sd15(), dtype=torch.bfloat16)
    unet = UNet2DConditionModel(cfg, lora_rank=0, device="cuda")
    with torch.no_grad():
        init_weights_(unet, torch.Generator(device="cuda").manual_seed(SEED + 26))
    ref = copy.deepcopy(unet)
    plan = ptp.apply_tp(unet, mesh)
    inner, calls, runs = oq.quantize, [], {}

    def recording(x, groups, role="act", group=None):
        q, sc = inner(x, groups, role, group)
        calls[-1].append((q.reshape(groups, -1), sc))
        return q, sc

    oq.quantize = recording
    try:
        with torch.no_grad():
            for key, model in (("ref", ref), ("tp", unet)):
                for kern in oq.KERNELS:
                    kern.reset_counts()
                calls.append([])
                weights = mq.quantize_unet(model)
                with mq.installed(model, weights):
                    eps = model(x.bfloat16(), t, ctx.bfloat16())
                torch.cuda.synchronize()
                runs[key] = (weights, eps, calls[-1], {k.symbol: k.launches for k in oq.KERNELS})
    finally:
        oq.quantize = inner
    (w0, e0, a0, n0), (w1, e1, a1, n1) = runs["ref"], runs["tp"]
    weights_equal = 0
    for name, w in w0.items():
        shard = plan.get(name + ".weight")
        q = ptp.shard_of(w.q, shard, mesh.model_index, mesh.model) if shard else w.q
        sc = (ptp.shard_of(w.scale, shard, mesh.model_index, mesh.model)
              if shard and shard.dim == 0 else w.scale)
        weights_equal += torch.equal(q, w1[name].q) and torch.equal(sc, w1[name].scale)
    acts_equal, first_diff = 0, None
    for i, ((q0, s0), (q1, s1)) in enumerate(zip(a0, a1)):
        if q1.shape[1] != q0.shape[1]:          # a row-parallel input: this rank's block
            k = q1.shape[1]
            q0 = q0[:, mesh.model_index * k:(mesh.model_index + 1) * k]
        same = torch.equal(q0, q1) and torch.equal(s0, s1)
        acts_equal += same
        if not same and first_diff is None:
            first_diff = i
    row = sum(1 for n in w1 if getattr(unet.get_submodule(n), "row_group", None))
    out = {"weights": (weights_equal, len(w0)), "acts": (acts_equal, len(a0), len(a1)),
           "first_diff": first_diff, "eps": torch.equal(e0, e1), "row_layers": row,
           "launches_ref": n0, "launches_tp": n1,
           "finite": bool(torch.isfinite(e1).all())}
    del unet, ref, runs, w0, w1
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_tp(torch):
    """23: `parallel.tp.apply_tp` at M = 2 over two ranks on this card."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = _spawn(_child, 2, _tp_rank)
    log(f"  two ranks over Gloo on one card in {time.perf_counter() - t0:.1f} s")
    for rank, r in enumerate(out):
        worst_cos = min((c, n) for n, (c, _) in r["leaves"].items())
        worst_rel = max((e, n) for n, (_, e) in r["leaves"].items())
        log(f"  rank {rank}: {r['sharded']} tensors sharded; eps cos {r['eps'][0]:.7f}, "
            f"max rel {r['eps'][1]:.3e}; {len(r['leaves'])} LoRA gradients: worst cos "
            f"{worst_cos[0]:.7f} ({worst_cos[1]}), worst max rel {worst_rel[0]:.3e} "
            f"({worst_rel[1]}); kernel A launches by heads: unsharded {r['heads_ref']}, "
            f"sharded {r['heads_tp']}; sharded call + backward {r['seconds']:.3f} s "
            f"(two processes sharing one card), peak {r['peak']:.1f} GiB")
        ok = (r["finite"] and r["eps"][0] >= TP_COS and r["eps"][1] <= TP_REL
              and worst_cos[0] >= TP_COS and worst_rel[0] <= TP_REL
              and set(r["heads_ref"]) == {8} and set(r["heads_tp"]) == {4}
              and r["heads_ref"][8] == r["heads_tp"][4] > 0)
        if not ok:
            raise AssertionError(f"tensor parallelism, rank {rank}: {r['eps']}, "
                                 f"{worst_cos}, {worst_rel}, {r['heads_ref']}, "
                                 f"{r['heads_tp']}")
    sym = "comat_quant_s8"      # ops.quant.QUANT_KERNEL's entry point
    for rank, r in enumerate(out):
        q = r["int8"]
        extra = q["launches_tp"][sym] - q["launches_ref"][sym]
        log(f"  W8A8, rank {rank}: weight codes and scales equal in {q['weights'][0]} of "
            f"{q['weights'][1]} layers; activation codes and scales equal in {q['acts'][0]} "
            f"of {q['acts'][1]} quantize calls ({q['acts'][2]} sharded; first differing "
            f"{q['first_diff']}); eps equal: {q['eps']}; {q['row_layers']} row-parallel "
            f"layers; launches unsharded {q['launches_ref']}, sharded {q['launches_tp']} "
            f"(+{extra} quantize: weight and activation absmax passes of the row-parallel "
            f"layers)")
        want_extra = 2 * q["row_layers"]
        same_other = all(q["launches_ref"][k] == q["launches_tp"][k]
                         for k in q["launches_ref"] if k != sym)
        if not (q["finite"] and q["eps"] and q["weights"][0] == q["weights"][1]
                and q["acts"][0] == q["acts"][1] == q["acts"][2] > 0 and q["row_layers"] > 0
                and extra == want_extra and same_other):
            raise AssertionError(f"W8A8 under tensor parallelism, rank {rank}: {q}")


# ---- phase 24: the native host runtime ----

NATIVE_STEPS = 3
NATIVE_BATCHES = 24       # store batches of TRAIN_BATCH compared and timed
NATIVE_MERGES = 100


def write_byte_vocab(path, lines, n_merges):
    """A byte-level CLIP vocabulary in `path`: vocab.json with the 256 byte
    symbols, their </w> forms and `n_merges` merges learned greedily (the
    most frequent pair first) from the words of `lines`, CLIP's BOS and EOS
    ids; merges.txt. Returns (vocab path, merges path)."""
    import collections

    from comat_tpu_torch.text.tokenizer import _CLIP_PAT, bytes_to_unicode

    enc = bytes_to_unicode()
    words = collections.Counter()
    for line in lines:
        for tok in _CLIP_PAT.findall(line.lower()):
            sym = [enc[b] for b in tok.encode("utf-8")]
            words[tuple(sym[:-1] + [sym[-1] + "</w>"])] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, n in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += n
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append((a, b))
        merged = collections.Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    symbols = [enc[b] for b in range(256)]
    vocab = {}
    for tok in symbols + [t + "</w>" for t in symbols] + [a + b for a, b in merges]:
        vocab.setdefault(tok, len(vocab))
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 49406, 49407
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt")


def phase_native_host(torch, fa, cv, kernels, cli_argv, cli_median):
    """24 (module docstring). Returns the launches by kernel and shape of
    (d)'s trainer on the native pieces."""
    import random

    import numpy as np

    from comat_tpu_torch import native_host as nh
    from comat_tpu_torch.ops import _build
    from comat_tpu_torch.text.tokenizer import CLIPBPETokenizer
    from comat_tpu_torch.training import train_step as ts
    from comat_tpu_torch.training.arguments import parse_args
    from comat_tpu_torch.training.data import GanLatentStore, load_prompts, read_latent_index
    from comat_tpu_torch.training.trainer import Trainer

    work = os.path.join(REPO, "build", "chip_smoke", "native")   # build/ is ignored
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    log("  " + gpu_name_and_power())

    # (a) the host library from scratch
    built_dir = _build.HOST_BUILD_DIR
    _build.HOST_BUILD_DIR = os.path.join(work, "host")
    try:
        t0 = time.perf_counter()
        lib = _build.build_host("comat_host")
        build_s = time.perf_counter() - t0
    finally:
        _build.HOST_BUILD_DIR = built_dir
    log(f"  (a) g++ {' '.join(_build.HOST_FLAGS)} of csrc/comat_host.cpp in {build_s:.2f} s "
        f"({os.path.getsize(lib) / 2 ** 10:.0f} KiB; Unicode "
        f"{nh.load_native().ch_unicode_version().decode()})")

    # (b) the tokenizer on every line of the corpus
    corpus = load_prompts(os.path.join(REPO, GAN_GT_CORPUS))
    non_ascii = [p for p in corpus if not p.isascii()]
    vocab, merges = write_byte_vocab(os.path.join(work, "tokenizer"),
                                     corpus[:1000] + non_ascii, NATIVE_MERGES)
    py, native = CLIPBPETokenizer(vocab, merges), nh.NativeCLIPTokenizer(vocab, merges)
    t0 = time.perf_counter()
    want = py(corpus)
    py_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = native(corpus)
    native_s = time.perf_counter() - t0
    ids_equal = (np.array_equal(got["input_ids"], want["input_ids"])
                 and np.array_equal(got["eos_positions"], want["eos_positions"]))
    rows_equal = sum(bool(np.array_equal(a, b))
                     for a, b in zip(got["input_ids"], want["input_ids"]))
    log(f"  (b) {len(corpus)} prompts ({len(non_ascii)} non-ASCII: "
        f"{[p for p in non_ascii]}), vocabulary of {256 * 2 + NATIVE_MERGES} pieces: ids "
        f"and EOS positions equal {ids_equal} ({rows_equal} rows); CLIPBPETokenizer "
        f"{py_s:.3f} s, NativeCLIPTokenizer {native_s:.3f} s (cold caches, one call each)")
    if not ids_equal or len(non_ascii) != 4:
        raise AssertionError(f"native tokenizer: {rows_equal} of {len(corpus)} rows equal, "
                             f"{len(non_ascii)} non-ASCII prompts")

    # (c) phase 14's store, a second latent for some prompts, one NCHW file
    accum = os.path.join(REPO, "build", "chip_smoke", "accum")
    src_index = os.path.join(accum, "gan_store", "index.jsonl")
    prompts = load_prompts(os.path.join(accum, "prompts.txt"))
    src = read_latent_index(src_index)
    store = os.path.join(work, "store")
    os.makedirs(store)
    gen = np.random.default_rng(SEED + 24)
    index = os.path.join(store, "index.jsonl")
    with open(index, "w") as f:
        for i, p in enumerate(prompts):
            files = [os.path.join(os.path.dirname(src_index), rel) for rel in src[p]]
            if i % 2 == 0:
                lat = gen.standard_normal((64, 64, 4), np.float32)
                name = f"extra_{i}.npy"
                np.save(os.path.join(store, name), lat.transpose(2, 0, 1) if i == 6 else lat)
                files.append(name)
            for rel in files:
                f.write(json.dumps({"prompt": p, "file_path": rel}) + "\n")
    order = random.Random(SEED + 24)
    seq = [[order.choice(prompts) for _ in range(TRAIN_BATCH)] for _ in range(NATIVE_BATCHES)]
    n_store, p_store = nh.NativeLatentStore(index), GanLatentStore(index)
    n_s, p_s, same = [], [], True
    for batch in seq:
        t0 = time.perf_counter()
        a = n_store.batch(batch)
        n_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        b = p_store.batch(batch)
        p_s.append(time.perf_counter() - t0)
        same = same and a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    same = same and n_store.rng.getstate() == p_store.rng.getstate()
    n_store.close()
    log(f"  (c) {len(prompts)} prompts, {sum(len(v) for v in read_latent_index(index).values())}"
        f" latents (one NCHW): {NATIVE_BATCHES} batches of {TRAIN_BATCH} equal {same}; a "
        f"batch: NativeLatentStore median {sorted(n_s)[len(n_s) // 2] * 1e3:.3f} ms, "
        f"GanLatentStore {sorted(p_s)[len(p_s) // 2] * 1e3:.3f} ms (page cache warm after "
        f"the first)")
    if not same:
        raise AssertionError("the native store's batches are not GanLatentStore's")

    # (d) the trainer on the native pieces, then on the Python pieces
    argv = list(cli_argv)
    argv[argv.index("--training_prompts") + 1] = os.path.join(accum, "prompts.txt")
    argv += ["--gan_gt_path", index, "--tokenizer_dir", os.path.dirname(vocab),
             "--max_train_steps", str(NATIVE_STEPS)]
    probe = lambda: counts_by_role(fa, cv)  # noqa: E731

    def run(tag, swap):
        gc.collect()
        torch.cuda.empty_cache()
        reset(kernels)
        t0 = time.perf_counter()
        trainer = Trainer(parse_args(argv + ["--output_dir", os.path.join(work, tag)]),
                          probe=probe)
        held = (type(trainer.clip_tok).__name__, type(trainer.latent_store).__name__)
        if swap:
            trainer.clip_tok = CLIPBPETokenizer(vocab, merges)
            trainer.latent_store = GanLatentStore(index)
        batches = (list(trainer.dataset.epoch(0)) + list(trainer.dataset.epoch(1)))
        rows = [trainer.train_one(b) for b in batches[:NATIVE_STEPS]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = {"held": held, "rows": rows, "roles": _cli_roles(trainer), "wall": wall,
               "shapes": {kern.symbol: dict(kern.launches_by_shape) for kern in kernels},
               "g": {n: p.detach().cpu() for n, p in trainer.state.trainable.items()},
               "d": {n: p.detach().cpu() for n, p in trainer.d_state.trainable.items()}}
        del trainer
        return out

    nat, pyr = run("native", False), run("python", True)
    gc.collect()
    torch.cuda.empty_cache()
    keys = ("s_step", *ts.PHASES)
    for tag, r in (("native", nat), ("python", pyr)):
        for i, m in enumerate(r["rows"], 1):
            log(f"  (d) {tag} {r['held'] if tag == 'native' else '(swapped in)'} step {i}: "
                f"loss {m['step_loss']!r}; " + ", ".join(f"{k} {m[k]:.3f}" for k in keys))
    med = {tag: _median(r["rows"][1:], ("s_step",)) for tag, r in (("native", nat),
                                                                   ("python", pyr))}
    differ = [f"g.{n}" for n in nat["g"] if not torch.equal(nat["g"][n], pyr["g"][n])]
    differ += [f"d.{n}" for n in nat["d"] if not torch.equal(nat["d"][n], pyr["d"][n])]
    losses = [m["step_loss"] for m in nat["rows"]] == [m["step_loss"] for m in pyr["rows"]]
    want_roles = {role: {k: n * NATIVE_STEPS for k, n in c.items()}
                  for role, c in CLI_LAUNCHES.items()}
    log(f"  (d) s_step median of steps 2-{NATIVE_STEPS}: native pieces "
        f"{med['native']['s_step']:.3f} s, Python pieces {med['python']['s_step']:.3f} s "
        f"(phase 9: {cli_median['s_step']:.3f} s); runs {nat['wall']:.1f} and "
        f"{pyr['wall']:.1f} s with construction; losses equal {losses}; "
        f"{len(nat['g'])} G and {len(nat['d'])} D tensors, {len(differ)} differ; launches by "
        f"kernel, shape and role equal {nat['roles'] == pyr['roles']} "
        f"{nat['shapes'] == pyr['shapes']}; {nat['roles']}, phase 9's a step times "
        f"{NATIVE_STEPS}: {nat['roles'] == want_roles}")
    if (nat["held"] != ("NativeCLIPTokenizer", "NativeLatentStore") or not losses or differ
            or nat["roles"] != pyr["roles"] or nat["shapes"] != pyr["shapes"]
            or set(nat["g"]) != set(pyr["g"])):
        raise AssertionError(f"native pieces: held {nat['held']}, losses {losses}, differ "
                             f"{differ[:5]}, roles {nat['roles']} / {pyr['roles']}")
    return nat["shapes"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from comat_tpu_torch.ops import _build
    from comat_tpu_torch.ops import conv3x3 as cv
    from comat_tpu_torch.ops import flash_attention as fa
    from comat_tpu_torch.ops import quant as oq

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    starts = []     # (phase, start time, GiB allocated when it starts)

    def header(text: str) -> None:
        starts.append((len(starts) + 1, time.perf_counter(),
                       torch.cuda.memory_allocated() / 2 ** 30))
        log(text)
        log(f"  at the start: {_gib(torch)}")

    log(gpu_name_and_power())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    header(f"[1/{N_PHASES}] build")
    t0 = time.perf_counter()
    paths = _build.build(["flash_fwd", "flash_bwd", "conv3x3", "conv3x3_dw", "quant_s8",
                          "conv_s8"])
    log(f"  built {len(paths)} sources in {time.perf_counter() - t0:.1f} s")
    for path in paths.values():
        if os.path.exists(path + ".log"):
            for line in open(path + ".log"):
                if any(w in line for w in ("entry function", "registers", "spill",
                                           "warning")):
                    log("  " + line.strip())
    phase_sass(paths)
    kernels = [fa.KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL, cv.KERNEL, cv.DW_KERNEL, *oq.KERNELS]

    header(f"[2/{N_PHASES}] kernels against their plain versions")
    t0 = time.perf_counter()
    entries = phase_kernels(torch, fa, cv)
    log(f"  {len(entries)} checks in {time.perf_counter() - t0:.1f} s")

    header(f"[3/{N_PHASES}] generation: SD1.5 fp32 256^2 card vs CPU")
    phase_parity(torch, kernels)

    header(f"[4/{N_PHASES}] full train step: SD1.5 + BLIP-large + D fp32 256^2 card vs CPU")
    tune_vae_shapes = phase_train_parity(torch, fa, cv, kernels)

    header(f"[5/{N_PHASES}] generation main path: SD1.5 512^2 bf16, 2 prompts, 50 DDPM steps")
    gen = phase_main(torch, kernels)
    gen_shapes = gen[0]

    header(f"[6/{N_PHASES}] train main path: SD1.5 + BLIP-large 512^2, 4 prompts, 50 steps, K 5")
    train_shapes, _, (pipe, blip, batch) = phase_train_main(torch, fa, cv, kernels)

    header(f"[7/{N_PHASES}] train with the VAE trained: the recipe, bf16 decoder, fp32 masters")
    tune_bf16_shapes, _, _ = phase_train_tune_vae(torch, fa, cv, kernels, pipe, blip, batch)

    header(f"[8/{N_PHASES}] full recipe: + GAN (D LoRA 128) + attribute concentration, A 2")
    full_shapes, full_median, full_peak = phase_train_full(torch, fa, cv, kernels, pipe,
                                                           blip, batch)
    del pipe, blip, batch

    header(f"[9/{N_PHASES}] trainer CLI: comat_tpu_torch/scripts/sd15.sh's flags (Grounded-SAM), "
        f"512^2, batch 4, {CLI_STEPS} steps, then a run resumed at step {CLI_RESUME}")
    cli_shapes, encode_shapes, cli_median, cli_peak, cli = phase_trainer_cli(
        torch, fa, cv, kernels, full_median, full_peak)

    header(f"[10/{N_PHASES}] Grounded-SAM: GroundingDINO-T 800^2 + FastSAM-x 512^2 fp32 card vs CPU, "
        "then bf16 at batch 4")
    phase_gsam(torch)

    header(f"[11/{N_PHASES}] SDXL: both text towers, one guided UNet call at 512^2 and the decode, "
        "fp32 card vs CPU")
    phase_sdxl_parity(torch, fa, cv, kernels)

    header(f"[12/{N_PHASES}] SDXL trainer CLI: comat_tpu_torch/scripts/sdxl.sh's flags (SD1.5 D, "
        f"Grounded-SAM, remat), 512^2, batch {SDXL_BATCH}, {SDXL_STEPS} steps")
    sdxl_shapes, sdxl_encode_shapes, sdxl_median, sdxl_peak, sdxl_index = phase_sdxl_trainer(
        torch, fa, cv, kernels, cli_median, cli_peak)

    header(f"[13/{N_PHASES}] snapshots: SD1.5 and BLIP-large fp32 in a hub cache, the generator and "
        f"the trainer ({SNAPSHOT_STEPS} steps) from them; SDXL's fp16 variant files")
    snap_gen_shapes, snap_cli_shapes = phase_snapshots(torch, fa, cv, kernels, gen, cli)
    cli_index, cli_argv, cli_step1 = cli["index"], cli["argv"], cli["step1"]["loss"]
    cli_first = cli["step1"]
    del gen, cli

    header(f"[14/{N_PHASES}] latent store: tools.gan_gt_generate on {GAN_GT_PROMPTS} prompts at 512^2, "
        f"then the trainer on it with --gradient_accumulation_steps {ACCUM_N}, "
        f"{ACCUM_STEPS} micro-steps and a resume at {ACCUM_RESUME}")
    store_shapes, accum_shapes = phase_gan_store_accum(torch, fa, cv, kernels, cli_median,
                                                       cli_peak)

    header(f"[15/{N_PHASES}] evaluator: BLIP-VQA base fp32 card vs CPU, then tools.evaluate on "
        f"{EVAL_PROMPTS} prompts at 512^2 (BLIP reward and BLIP-VQA binding)")
    eval_shapes = phase_evaluate(torch, fa, cv, kernels)

    header(f"[16/{N_PHASES}] SD1.5 surfaces: (a) --full_finetuning + text LoRA 8 + CLIP-L fp32 256^2 "
           "card vs CPU; (b) sd15.sh's flags + " + " ".join(SURFACE_FLAGS)
           + f", {SURF_STEPS} steps, then a run resumed at step {SURF_RESUME}")
    phase_surfaces_parity(torch, fa, cv, kernels)
    surf_shapes, _, _ = phase_surfaces_trainer(torch, fa, cv, kernels, cli_index,
                                               cli_median, cli_peak)

    header(f"[17/{N_PHASES}] SDXL surfaces: sdxl.sh's flags + " + " ".join(SURFACE_FLAGS)
           + f", {SXS_STEPS} steps at batch {SDXL_BATCH} (or the largest that fits)")
    sxs_shapes, sxs_batch = phase_sdxl_surfaces(torch, fa, cv, kernels, sdxl_index,
                                                sdxl_median, sdxl_peak)

    header(f"[18/{N_PHASES}] int8 kernels: quantize, int8 conv, dequantize against their "
           "plain versions at every quantized layer of SD1.5 (CFG 8) and SDXL (CFG 12)")
    pipes = _int8_pipelines(torch)
    entries += phase_int8_kernels(torch, oq, pipes)

    header(f"[19/{N_PHASES}] W8A8 pass 1: 50 guided calls bf16 vs int8 (SD1.5 batch 4, "
           f"SDXL batch {SDXL_BATCH}), then sd15.sh's flags + --pass1_int8, {INT8_STEPS} steps")
    int8_shapes = phase_int8_pass1(torch, kernels, oq, pipes)
    del pipes
    int8_cli_shapes = phase_int8_trainer(torch, fa, cv, oq, kernels, cli_argv, cli_step1,
                                         cli_median, cli_peak)

    header(f"[20/{N_PHASES}] v-prediction: phase 4's fp32 card vs CPU, then with "
           "--pass1_int8 (activation codes card vs CPU)")
    phase_train_parity(torch, fa, cv, kernels, prediction_type="v_prediction")
    phase_train_parity(torch, fa, cv, kernels, prediction_type="v_prediction", oq=oq)

    header(f"[21/{N_PHASES}] stability: tools/stability_run.py, {STABILITY_STEPS} steps")
    stability_shapes = phase_stability(torch, kernels)

    header(f"[22/{N_PHASES}] data parallelism: (a) sd15.sh's flags, {DDP_STEPS} steps under a "
           f"world-1 NCCL group against phase 9; (b) two ranks on this card over Gloo at "
           f"batch {TRAIN_BATCH // 2} each against one process at batch {TRAIN_BATCH}")
    ddp_shapes = phase_ddp_world1(torch, fa, cv, kernels, cli_argv, cli_first["steps"])
    phase_ddp_world2(torch, cli_argv, TRAIN_BATCH)
    del cli_first

    header(f"[23/{N_PHASES}] tensor parallelism: SD1.5's UNet at full width (fp32) sharded "
           "over two ranks on this card (Gloo), one guided call at 512^2 and its LoRA backward; "
           "then W8A8 on the sharded bf16 UNet against the unsharded")
    phase_tp(torch)

    header(f"[24/{N_PHASES}] native host runtime: the g++ build, the C++ tokenizer on the "
           f"corpus, the C++ latent store, then sd15.sh's flags on the native pieces for "
           f"{NATIVE_STEPS} steps against the Python pieces")
    native_shapes = phase_native_host(torch, fa, cv, kernels, cli_argv, cli_median)
    ends = [t for _, t, _ in starts[1:]] + [time.perf_counter()]
    log("  seconds a phase (GiB allocated at its start): " + ", ".join(
        f"{n} {end - t:.1f} ({held:.2f})" for (n, t, held), end in zip(starts, ends)))

    # launches: those of the driven paths, each counted from 0 just before
    # it: generation, the reduced recipe's train step, the same with the
    # VAE trained (bf16), dw in the fp32 train step with the VAE trained
    # (phase 4's card run), the full recipe's step, the latent store's
    # encoding and the trainer CLI's two runs, SDXL's latent store and
    # its trainer CLI's run, the generation and the trainer's run from the
    # SD1.5 snapshot, the latent tool's store, the accumulated trainer's two
    # runs and the evaluator
    paths = {"generate": gen_shapes, "train": train_shapes,
             "train_tune_vae_bf16": tune_bf16_shapes,
             "train_tune_vae": {cv.DW_KERNEL.symbol: tune_vae_shapes[cv.DW_KERNEL.symbol]},
             "train_full": full_shapes, "gan_store_encode": encode_shapes,
             "trainer_cli": cli_shapes, "sdxl_gan_store_encode": sdxl_encode_shapes,
             "sdxl_trainer_cli": sdxl_shapes, "snapshot_generate": snap_gen_shapes,
             "snapshot_trainer_cli": snap_cli_shapes, "gan_gt_generate": store_shapes,
             "accum_trainer_cli": accum_shapes, "evaluate": eval_shapes,
             "surfaces_trainer_cli": surf_shapes, "sdxl_surfaces_trainer": sxs_shapes,
             "int8_pass1_sd15": int8_shapes["sd15"], "int8_pass1_sdxl": int8_shapes["sdxl"],
             "int8_trainer_cli": int8_cli_shapes, "stability": stability_shapes,
             "ddp_trainer_cli": ddp_shapes, "native_trainer_cli": native_shapes}
    if sxs_batch != SDXL_BATCH:
        log(f"  phase 17 ran at batch {sxs_batch}, whose shapes phase 2 does not time: "
            "its launches are left out of the kernels line")
    for e in entries:
        key = tuple(e.pop("key"))
        for path, shapes in paths.items():
            e[f"launches_{path}"] = shapes.get(e["kernel"], {}).get(key, 0)
        e["launches"] = sum(e[f"launches_{path}"] for path in paths)
    measured = {(e["kernel"], tuple(e["shape"]), e["dtype"]) for e in entries}
    for path in paths.values():
        for symbol, counts in path.items():
            # a conv launch key ends in its role ("fwd" or "dx"), a
            # quantize's in its role ("act" or "weight")
            strip = 2 if symbol in (cv.KERNEL.symbol, oq.QUANT_KERNEL.symbol) else 1
            missing = {k: n for k, n in counts.items()
                       if (symbol, k[:-strip], k[-strip]) not in measured}
            if missing:
                raise AssertionError(f"{symbol}: main-path shapes not measured: {missing}")
    # each kernel's share of the main paths, from its per-shape times above
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "conv3x3_fwd", "conv3x3_dx", "conv3x3_dw",
                 "quant_s8", "dequant_s8", "conv_s8"):
        for path in paths:
            sel = [e for e in entries if e["name"] == name and e[f"launches_{path}"]]
            if not sel:
                continue
            n = sum(e[f"launches_{path}"] for e in sel)
            total_ms = {key: (sum(e[f"launches_{path}"] * e[key] for e in sel)
                              if all(e[key] is not None for e in sel) else math.nan)
                        for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
            log(f"  {name} on the {path} path: {n} launches x ms = "
                f"{total_ms['ms']:.1f} ms (plain {total_ms['plain_ms']:.1f}, "
                f"library {total_ms['library_ms']:.1f}, bound {total_ms['bound_ms']:.2f})")
            if path == "sdxl_trainer_cli":      # its steps alone: no validation
                log(f"    a step of the SDXL trainer: {n / SDXL_STEPS:g} launches, "
                    + ", ".join(f"{k} {v / SDXL_STEPS:.2f}" for k, v in total_ms.items()))
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
