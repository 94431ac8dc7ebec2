"""Offline GAN ground-truth latent generator for the PyTorch port.

Port of comat_tpu/tools/gan_gt_generate.py: sample latents for a prompt
corpus with the base model (or a trained LoRA over it) and store them for
the latent GAN's discriminator (`--gan_gt_path` of the trainer, the
launchers' `GAN_GT_PATH`). The contract is JAX's: `<save-path>/index.jsonl`
with {"prompt", "file_path"} lines and one `latents/<uuid>.npy` per sample
(NHWC float32, which `training.data.GanLatentStore` reads); --start/--end
take a slice of the corpus; --use-cache skips the prompts the index holds
already; the last batch is padded with "" prompts up to --batch-size; the
sampler stops at the latents (no VAE decode).

Weights as `tools/generate.py` takes them: the towers from the diffusers
snapshot --pretrain-model names (a folder, or a repo id in --cache-dir's
hub cache), else seeded from --seed; --checkpoint puts a trained LoRA over
them, its rank read from the file. Sampling runs one LoRA-fused UNet
(`DiffusionPipeline.fused_unet`), made once for every batch; SDXL's second
tower reads the pad-id-0 tokenizer's ids (JAX's tool hands it the first
tokenizer's). A full-size run without a snapshot or without CLIP tokenizer
files refuses unless --allow-smoke. Each batch's initial latents and
per-step noise are drawn from one `torch.Generator` seeded by --seed and
handed to `sample_batch`, which a caller may feed other draws
(`load_sampler` and `sample_prompts` serve `tools/evaluate.py` too). On
CUDA unless --device cpu. Example:

    python -m comat_tpu_torch.tools.gan_gt_generate \\
        --prompt-path collected_data/abc5k.txt --save-path gan_store \\
        --pretrain-model runwayml/stable-diffusion-v1-5 --cache-dir ~/hf \\
        --tokenizer-dir <snapshot>/tokenizer
    GAN_GT_PATH=gan_store/index.jsonl comat_tpu_torch/scripts/sd15.sh
"""

from __future__ import annotations

import argparse
import json
import os
import time
import uuid
from typing import Any, Dict, List, NamedTuple


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Generate GAN GT latents")
    p.add_argument("--model", default="sd_1_5", help="pipeline name (sd_1_5 / sdxl)")
    p.add_argument("--prompt-path", required=True)
    p.add_argument("--save-path", required=True)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=7.5)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=-1)
    p.add_argument("--use-cache", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None,
                   help="the trainer's checkpoint-{step} folder or a "
                        "pytorch_lora_weights.safetensors")
    p.add_argument("--pretrain-model", default=None,
                   help="diffusers snapshot folder, or a repo id under --cache-dir")
    p.add_argument("--cache-dir", default=None, help="HF hub cache root")
    p.add_argument("--tokenizer-dir", default=None)
    p.add_argument("--tiny", action="store_true",
                   help="tiny random-weight geometry (smoke testing)")
    p.add_argument("--allow-smoke", action="store_true",
                   help="permit seeded weights or a hash tokenizer at full size")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


class Sampler(NamedTuple):
    """What a sampling tool holds for its run (`load_sampler`)."""

    pipe: Any           # DiffusionPipeline, weights loaded
    tok: Any            # CLIP tokenizer
    tok2: Any           # SDXL's second tokenizer (pad id 0), else None
    unet: Any           # the LoRA-fused UNet, made once for every batch
    generator: Any      # torch.Generator seeded by --seed, for the draws


def load_sampler(args, what: str) -> Sampler:
    """The pipeline of --model at --resolution on --device, its towers and
    --checkpoint's LoRA loaded as `tools/generate.py` loads them (the ranks
    read from the file), its tokenizers, fused UNet and generator. A
    full-size run without --pretrain-model or CLIP tokenizer files goes
    through the smoke gate; `what` names the output in its message."""
    import torch

    from comat_tpu_torch.models.pipeline import DiffusionPipeline, make_pipeline_config
    from comat_tpu_torch.text.tokenizer import HashTokenizer, load_clip_tokenizer
    from comat_tpu_torch.tools.generate import _load_weights, lora_checkpoint, smoke_gate

    lora_path, rank, text_rank = lora_checkpoint(args.checkpoint)
    if not args.tiny and not args.pretrain_model:
        smoke_gate(args.allow_smoke, f"no --pretrain-model: {what} would come from "
                   f"towers seeded by --seed {args.seed}")
    pcfg = make_pipeline_config(args.model, lora_rank=rank, text_lora_rank=text_rank,
                                resolution=args.resolution, tiny=args.tiny)
    tok = (HashTokenizer(pcfg.text.vocab_size) if args.tiny
           else load_clip_tokenizer(args.tokenizer_dir))
    if not args.tiny and isinstance(tok, HashTokenizer):
        smoke_gate(args.allow_smoke, "no CLIP tokenizer files found (--tokenizer-dir); a "
                   "HashTokenizer would feed garbage ids to the text encoder")
    tok2 = None
    if pcfg.is_sdxl:
        tok2 = (HashTokenizer(pcfg.text.vocab_size, pad_token_id=0) if args.tiny
                else load_clip_tokenizer(args.tokenizer_dir, pad_token_id=0))
    pipe = DiffusionPipeline(pcfg, device=args.device, seed=args.seed)
    _load_weights(args, pipe, lora_path)
    return Sampler(pipe, tok, tok2, pipe.fused_unet(),
                   torch.Generator(device=pipe.device).manual_seed(args.seed))


def sample_batch(pipe, unet, enc, null, latents0, step_noise, num_inference_steps: int,
                 guidance_scale: float, ids2=None, null2=None):
    """One batch's final latents (B, h, w, 4) fp32: DDPM through `unet` (as
    `pipe.fused_unet()` returns it) from the injected `latents0`
    (B, h, w, 4) and `step_noise` (S, B, h, w, 4), no decode."""
    import torch

    latents = pipe.generate(
        enc["input_ids"], null["input_ids"],
        num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
        eos_positions=enc["eos_positions"], input_ids2=ids2, null_ids2=null2,
        output_type="latent", latents0=latents0, step_noise=step_noise, unet=unet)
    return latents.to(torch.float32)


def sample_prompts(sampler: Sampler, prompts: List[str], num_inference_steps: int,
                   guidance_scale: float):
    """`sample_batch` of `prompts` against as many null prompts, its initial
    latents and then its per-step noise drawn from the sampler's
    generator."""
    import torch

    pipe, tok, tok2 = sampler.pipe, sampler.tok, sampler.tok2
    B, L, s = len(prompts), pipe.cfg.text.max_length, pipe.cfg.latent_size
    enc, null = tok(prompts, max_length=L), tok([""] * B, max_length=L)
    ids2 = null2 = None
    if tok2 is not None:
        ids2 = tok2(prompts, max_length=L)["input_ids"]
        null2 = tok2([""] * B, max_length=L)["input_ids"]
    g = sampler.generator
    latents0 = torch.randn((B, s, s, 4), generator=g, device=pipe.device)
    noise = torch.randn((num_inference_steps, B, s, s, 4), generator=g, device=pipe.device)
    return sample_batch(pipe, sampler.unet, enc, null, latents0, noise, num_inference_steps,
                        guidance_scale, ids2, null2)


def main(argv=None) -> Dict[str, object]:
    """Write the store; returns {"generated": prompts written this call,
    "batch_s": wall seconds of each batch's sampling}."""
    args = parse_args(argv)
    from comat_tpu_torch.training.data import load_prompts

    prompts = load_prompts(args.prompt_path)
    end = args.end if args.end >= 0 else len(prompts)
    prompts = prompts[args.start:end]

    index_path = os.path.join(args.save_path, "index.jsonl")
    done = set()
    if args.use_cache and os.path.exists(index_path):
        with open(index_path) as f:
            done = {json.loads(line)["prompt"] for line in f if line.strip()}
    todo = [p for p in prompts if p not in done]
    print(f"{len(todo)} prompts to generate ({len(done)} cached)")
    result: Dict[str, object] = {"generated": 0, "batch_s": []}
    if not todo:
        return result

    import numpy as np

    sampler = load_sampler(args, "the latents")
    B = args.batch_size
    os.makedirs(os.path.join(args.save_path, "latents"), exist_ok=True)
    with open(index_path, "a") as f_index:
        for i in range(0, len(todo), B):
            chunk: List[str] = todo[i:i + B]
            t0 = time.perf_counter()
            latents = sample_prompts(sampler, chunk + [""] * (B - len(chunk)),
                                     args.num_inference_steps,
                                     args.guidance_scale).cpu().numpy()
            result["batch_s"].append(time.perf_counter() - t0)
            for j, prompt in enumerate(chunk):
                name = f"latents/{uuid.uuid4().hex[:12]}.npy"
                np.save(os.path.join(args.save_path, name), latents[j])
                f_index.write(json.dumps({"prompt": prompt, "file_path": name}) + "\n")
            f_index.flush()
            result["generated"] += len(chunk)
            print(f"generated {min(i + B, len(todo))}/{len(todo)} "
                  f"({result['batch_s'][-1]:.3f} s for the batch)")
    return result


if __name__ == "__main__":
    main()
