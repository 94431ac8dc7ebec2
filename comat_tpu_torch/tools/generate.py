"""Text-to-image generation CLI for the PyTorch port.

Port of comat_tpu/tools/generate.py: prompts -> PNG images with the
DDPM, DDIM or DPM++ 2M sampler, on CUDA unless `--device cpu`, for SD1.5
(`--model sd_1_5`) or SDXL (`--model sdxl`: both text towers, the second
reading the pad-id-0 tokenizer's ids). The towers load from the diffusers
snapshot `--pretrain-model` names (a folder, or a repo id resolved
through `--cache-dir`'s hub cache), else keep weights drawn from `--seed`;
`--checkpoint` puts a trained LoRA over them: a checkpoint folder of the
port's trainer (its `pytorch_lora_weights.safetensors`, with the text
towers' LoRA and the towers it trained whole) or such a file, the ranks
read from the file. Sampling runs the UNet with the LoRA folded in. Examples:

    python -m comat_tpu_torch.tools.generate --tiny --device cpu \\
        --prompt "a red cube"
    python -m comat_tpu_torch.tools.generate --model sdxl --prompt "a red cube"
    python -m comat_tpu_torch.tools.generate --prompt "a red cube" \\
        --pretrain-model runwayml/stable-diffusion-v1-5 --cache-dir ~/hf \\
        --tokenizer-dir <snapshot>/tokenizer --checkpoint out/checkpoint-2000
"""

from __future__ import annotations

import argparse
import os
import struct
import time
import zlib
from typing import Dict, Optional, Tuple


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="comat_tpu_torch text-to-image")
    p.add_argument("--model", default="sd_1_5")
    p.add_argument("--prompt", nargs="+", required=True)
    p.add_argument("--out-dir", default="generated")
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=7.5)
    p.add_argument("--scheduler", default="ddpm", choices=["ddpm", "ddim", "dpmpp"])
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tokenizer-dir", default=None)
    p.add_argument("--pretrain-model", default=None,
                   help="diffusers snapshot folder, or a repo id under --cache-dir")
    p.add_argument("--cache-dir", default=None, help="HF hub cache root")
    p.add_argument("--checkpoint", default=None,
                   help="the trainer's checkpoint-{step} folder or a "
                        "pytorch_lora_weights.safetensors")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def write_png(path: str, image) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    h, w, _ = image.shape
    raw = b"".join(b"\x00" + image[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def _load_weights(args, pipe, lora_path) -> None:
    """The snapshot, then the checkpoint, into `pipe` in place; a tensor
    either lacks raises. Prints the bytes and seconds of the loads."""
    from comat_tpu_torch.models import hf_import

    reports = []
    if args.pretrain_model:
        snap = hf_import.resolve_snapshot(args.pretrain_model, args.cache_dir)
        if not (snap and os.path.isdir(snap)):
            raise FileNotFoundError(f"--pretrain-model {args.pretrain_model!r}: no snapshot "
                                    f"folder (looked at {snap!r})")
        for tower, r in hf_import.load_sd_state(snap, pipe).items():
            if r.missing:
                raise ValueError(f"{snap}: {tower} lacks {len(r.missing)} tensors "
                                 f"(first: {r.missing[:5]})")
            if r.unused:
                print(f"{snap}: {len(r.unused)} unused {tower} tensors "
                      f"(first: {r.unused[:3]})")
            reports.append(r)
    else:
        print(f"no --pretrain-model: the towers keep weights drawn from --seed {args.seed}")
    if lora_path:
        # the UNet's and the text towers' factors, and the towers the
        # trainer trained whole, exported under the port's own names
        lora_reports = hf_import.load_lora_state(lora_path, pipe)
        bad = [n for r in lora_reports.values() for n in r.missing + r.unused]
        reports += lora_reports.values()
        if bad:
            raise ValueError(f"{lora_path}: {len(bad)} tensors missing or not the "
                             f"pipeline's (first: {bad[:5]})")
    if reports:
        print(f"loaded {sum(r.nbytes for r in reports) / 1e9:.3f} GB of weights: read "
              f"{sum(r.read_s for r in reports):.3f} s, copied to {pipe.device} in "
              f"{sum(r.copy_s for r in reports):.3f} s")


def lora_checkpoint(checkpoint: Optional[str]) -> Tuple[Optional[str], int, int]:
    """(the LoRA file, its UNet rank, its text towers' rank) of
    --checkpoint: the trainer's checkpoint folder (its
    pytorch_lora_weights.safetensors) or such a file; (None, 0, 0)
    without one. A file without UNet factors raises."""
    if not checkpoint:
        return None, 0, 0
    from comat_tpu_torch.models.hf_import import lora_rank

    path = (os.path.join(checkpoint, "pytorch_lora_weights.safetensors")
            if os.path.isdir(checkpoint) else checkpoint)
    rank = lora_rank(path)
    if not rank:
        raise ValueError(f"--checkpoint {path}: no UNet LoRA factors")
    return path, rank, lora_rank(path, "text")


def smoke_gate(allow_smoke: bool, why: str) -> None:
    """Refuse a fidelity-degrading fallback (seeded weights, a hash
    tokenizer) unless --allow-smoke, which prints it instead."""
    if not allow_smoke:
        raise SystemExit(f"refusing to continue: {why}. Pass --allow-smoke to run "
                         "anyway (smoke testing only).")
    print(f"SMOKE MODE: {why}")


def main(argv=None) -> Tuple["torch.Tensor", Dict[str, float]]:
    """Generate, write `<out-dir>/NNN.png`, and return (images (B, H, W, 3)
    in [0, 1], {"sample_s", "decode_s"} wall seconds)."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from comat_tpu_torch.models.pipeline import (
        DiffusionPipeline, make_pipeline_config,
    )
    from comat_tpu_torch.text.tokenizer import HashTokenizer, load_clip_tokenizer

    lora_path, rank, text_rank = lora_checkpoint(args.checkpoint)
    pcfg = make_pipeline_config(
        args.model, lora_rank=rank, text_lora_rank=text_rank,
        resolution=args.resolution, tiny=args.tiny,
    )
    pipe = DiffusionPipeline(pcfg, device=args.device, seed=args.seed)
    _load_weights(args, pipe, lora_path)
    tok = (HashTokenizer(pcfg.text.vocab_size) if args.tiny
           else load_clip_tokenizer(args.tokenizer_dir))
    prompts = list(args.prompt)
    L = pcfg.text.max_length
    enc = tok(prompts, max_length=L)
    null = tok([""] * len(prompts), max_length=L)
    ids2 = null2 = None
    if pcfg.is_sdxl:
        tok2 = (HashTokenizer(pcfg.text.vocab_size, pad_token_id=0) if args.tiny
                else load_clip_tokenizer(args.tokenizer_dir, pad_token_id=0))
        ids2 = tok2(prompts, max_length=L)["input_ids"]
        null2 = tok2([""] * len(prompts), max_length=L)["input_ids"]
    generator = torch.Generator(device=pipe.device).manual_seed(args.seed)

    def sync():
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)

    sync()
    t0 = time.perf_counter()
    latents = pipe.generate(
        enc["input_ids"], null["input_ids"],
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale,
        eos_positions=enc["eos_positions"],
        input_ids2=ids2,
        null_ids2=null2,
        kind=args.scheduler,
        output_type="latent",
        generator=generator,
    )
    sync()
    t1 = time.perf_counter()
    with torch.no_grad():
        images = pipe.decode_image(latents).clamp(0.0, 1.0)
    sync()
    t2 = time.perf_counter()

    os.makedirs(args.out_dir, exist_ok=True)
    arr = (images.float().cpu().numpy() * 255).astype(np.uint8)
    for i, (p, im) in enumerate(zip(prompts, arr)):
        path = os.path.join(args.out_dir, f"{i:03d}.png")
        write_png(path, im)
        print(f"{path}: {p}")
    timings = {"sample_s": t1 - t0, "decode_s": t2 - t1}
    print(
        f"sampled {args.num_inference_steps} steps in {timings['sample_s']:.3f} s "
        f"({timings['sample_s'] / args.num_inference_steps:.4f} s/step), "
        f"decoded in {timings['decode_s']:.3f} s on {pipe.device}"
    )
    return images, timings


if __name__ == "__main__":
    main()
