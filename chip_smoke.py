#!/usr/bin/env python3
"""Smoke run of the PyTorch port (comat_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure ends the run with a nonzero exit and no result line:
1. build: print the card's name and power limit, build every CUDA kernel
   of the generation path (one nvcc per source, all at once);
2. kernels: each kernel against its plain PyTorch version at the shapes
   the main path gives it, in fp32 (TF32 off) and bf16, with its time,
   the plain version's, one PyTorch library call's, and its bound;
3. parity: SD1.5 at full width, fp32, 256^2, 1 prompt, 2 DDPM steps, the
   same seeded weights and injected noise on the card and on this
   machine's CPU; images within 1e-3;
4. main path: `comat_tpu_torch.tools.generate.main` at SD1.5 full width,
   512^2, bf16, 2 prompts, 50 DDPM steps, CFG 7.5, seeded weights, the
   hash tokenizer at vocab 49408; finite (2, 512, 512, 3) images and the
   expected kernel launch counts.
Then one JSON line {"kernels": [...], "checks": [...]} and, last, the
device line.
Weights are random (SD1.5's are not in the repository); depth is not cut.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
# |kernel - plain| <= ATOL + RTOL * |plain|, elementwise
TOLS = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 2.0 ** -7)}
FLASH_SHAPES = [  # (B, H, Sq, Skv, d): the main path's, plus a ragged one
    (4, 8, 4096, 4096, 40), (4, 8, 1024, 1024, 80), (4, 8, 256, 256, 160),
    (2, 1, 4096, 4096, 512), (1, 8, 1000, 1100, 80),
]
CONV_SHAPES = [  # (B, H, C, Cout): the 512^2 decoder's, batch 2
    (2, 128, 512, 512), (2, 256, 512, 512), (2, 256, 512, 256),
    (2, 256, 256, 256), (2, 512, 256, 256), (2, 512, 256, 128),
    (2, 512, 128, 128),
]
MAIN_FLASH_LAUNCHES = 15 * 50 + 1   # 15 self-attentions over >128 keys x 50 + VAE
MAIN_CONV_LAUNCHES = 21
PARITY_FLASH_LAUNCHES = 10 * 2 + 1  # 256^2: 5 at S=1024 and 5 at S=256, x 2 + VAE
PARITY_CONV_LAUNCHES = 14


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def bound_ms(flops: float, nbytes: float, dtype: str):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_close(name, got, want, dtype) -> float:
    atol, rtol = TOLS[dtype]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    excess = float((diff - rtol * want.float().abs()).max())
    if not math.isfinite(err) or excess > atol:
        raise AssertionError(
            f"{name}: max |kernel - plain| = {err:.3e} exceeds "
            f"{atol:g} + {rtol:g}*|plain|"
        )
    return err


def phase_kernels(torch, fa, cv):
    import torch.nn.functional as F

    entries = []
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for B, H, Sq, Skv, d in FLASH_SHAPES:
            # the (B, S, H, d) head split of a projection, as on the path
            q, k, v = (
                torch.randn(B, S, H, d, generator=gen, device="cuda")
                .to(dt).transpose(1, 2)
                for S in (Sq, Skv, Skv)
            )
            o, lse = fa.flash_attention(q, k, v, want_lse=True)
            o_ref, lse_ref = fa.flash_attention_ref(q, k, v)
            torch.cuda.synchronize()
            err = max(check_close("flash o", o, o_ref, dtype),
                      check_close("flash lse", lse, lse_ref, "float32"
                                  if dtype == "float32" else dtype))
            ms = time_ms(torch, lambda: fa.flash_attention(q, k, v))
            plain = time_ms(torch, lambda: fa.flash_attention_ref(q, k, v))
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
            nbytes = (2 * B * H * Sq * d + 2 * B * H * Skv * d) * q.element_size()
            bms, by = bound_ms(4.0 * B * H * Sq * Skv * d, nbytes, dtype)
            entries.append(dict(
                name="flash_attention_fwd", route="cuda",
                source="comat_tpu_torch/csrc/flash_fwd.cu",
                replaces="comat_tpu/ops/flash_attention.py:86",
                shape=[B * H, Sq, Skv, d], dtype=dtype,
                key=(B * H, Sq, Skv, d, dtype), max_abs_err=err,
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=lib, library="F.scaled_dot_product_attention",
            ))
            log(f"  flash {dtype} BH={B * H} Sq={Sq} Skv={Skv} d={d}: "
                f"err {err:.2e}, {ms:.3f} ms (plain {plain:.3f}, sdpa {lib:.3f}, "
                f"bound {bms:.3f} by {by})")
            del q, k, v, o, lse, o_ref, lse_ref
        for B, Hs, C, Cout in CONV_SHAPES:
            x = torch.randn(B, Hs, Hs, C, generator=gen, device="cuda").to(dt)
            w = (torch.randn(3, 3, C, Cout, generator=gen, device="cuda")
                 / math.sqrt(9 * C)).to(dt)
            y = cv.conv3x3_same(x, w)
            y_ref = cv.conv3x3_ref(x, w)
            torch.cuda.synchronize()
            err = check_close("conv3x3", y, y_ref, dtype)
            del y_ref
            x_nchw = x.permute(0, 3, 1, 2)              # channels_last view
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            ms = time_ms(torch, lambda: cv.conv3x3_same(x, w))
            plain = time_ms(torch, lambda: cv.conv3x3_ref(x, w))
            lib = time_ms(torch, lambda: F.conv2d(x_nchw, w_oihw, padding=1))
            nbytes = (B * Hs * Hs * (C + Cout) + 9 * C * Cout) * x.element_size()
            bms, by = bound_ms(2.0 * B * Hs * Hs * 9 * C * Cout, nbytes, dtype)
            entries.append(dict(
                name="conv3x3_fwd", route="cuda",
                source="comat_tpu_torch/csrc/conv3x3.cu",
                replaces="comat_tpu/ops/conv3x3.py:116",
                also_replaces="comat_tpu/ops/conv3x3.py:101",
                shape=[B, Hs, Hs, C, Cout], dtype=dtype,
                key=(B, Hs, Hs, C, Cout, dtype), max_abs_err=err,
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=lib, library="F.conv2d",
            ))
            log(f"  conv {dtype} B={B} {Hs}^2 {C}->{Cout}: err {err:.2e}, "
                f"{ms:.3f} ms (plain {plain:.3f}, conv2d {lib:.3f}, "
                f"bound {bms:.3f} by {by})")
            del x, w, y
    torch.cuda.empty_cache()
    return entries


def fp32_config(name: str, resolution: int):
    import torch

    from comat_tpu_torch.models.pipeline import make_pipeline_config

    cfg = make_pipeline_config(name, lora_rank=0, resolution=resolution)
    f32 = lambda c: dataclasses.replace(c, dtype=torch.float32)  # noqa: E731
    return dataclasses.replace(
        cfg, unet=f32(cfg.unet), text=f32(cfg.text), vae=f32(cfg.vae)
    )


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
    for kern in kernels:
        kern.reset_counts()
    t0 = time.perf_counter()
    img_gpu = gpu.generate(enc["input_ids"], null["input_ids"], **kw)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    counts = [kern.launches for kern in kernels]
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
    for kern in kernels:
        kern.reset_counts()
    t0 = time.perf_counter()
    images, timings = generate_main(argv)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = [kern.launches for kern in kernels]
    by_shape = [dict(kern.launches_by_shape) for kern in kernels]
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
    return timings, by_shape


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

    log("[1/4] build")
    t0 = time.perf_counter()
    paths = _build.build(["flash_fwd", "conv3x3"])
    log(f"  built in {time.perf_counter() - t0:.1f} s")
    for path in paths.values():
        if os.path.exists(path + ".log"):
            for line in open(path + ".log"):
                if "registers" in line or "spill" in line:
                    log("  " + line.strip())
    kernels = [fa.KERNEL, cv.KERNEL]

    log("[2/4] kernels against their plain versions")
    entries = phase_kernels(torch, fa, cv)

    log("[3/4] SD1.5 fp32 256^2 card vs CPU")
    phase_parity(torch, kernels)

    log("[4/4] main path: SD1.5 512^2 bf16, 2 prompts, 50 DDPM steps")
    _, by_shape = phase_main(torch, kernels)
    for e in entries:
        counts = by_shape[0] if e["name"] == "flash_attention_fwd" else by_shape[1]
        e["launches"] = counts.get(tuple(e.pop("key")), 0)
    for kern, counts in zip(kernels, by_shape):
        missing = {k: n for k, n in counts.items()
                   if not any(tuple(e["shape"]) == k[:-1] and e["dtype"] == k[-1]
                              for e in entries)}
        if missing:
            raise AssertionError(f"{kern.symbol}: main-path shapes not measured: {missing}")
    # each kernel's share of the main path, from its per-shape times above
    for name in ("flash_attention_fwd", "conv3x3_fwd"):
        sel = [e for e in entries if e["name"] == name and e["launches"]]
        total_ms = {key: sum(e["launches"] * e[key] for e in sel)
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"  {name} on the main path: launches x ms = {total_ms['ms']:.1f} ms "
            f"(plain {total_ms['plain_ms']:.1f}, library {total_ms['library_ms']:.1f}, "
            f"bound {total_ms['bound_ms']:.2f})")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    # "kernels": the shapes the main path launched; "checks": the other
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
