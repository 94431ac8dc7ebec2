"""Sustained SD1.5 training: N train steps in a row, each step's wall
seconds, loss and reward, the steady-state mean from step 2, images per
second, and whether every loss is finite.

Port of comat_tpu/tools/stability_run.py, built through the port's own
modules (JAX's tool builds through bench.py, which imports JAX): the step
that `bench.build(batch_size)` makes with its defaults, SD1.5 at published
widths (LoRA 128, bf16 towers, BLIP-large), 512^2, batch 4, seeded
weights, total_step 50, K 5, the reduced recipe (the BLIP reward; no GAN,
no attribute concentration), bench's prompts with their captions padded
to 32 tokens. Every step takes the same draws, from a generator seeded
anew with 11, as JAX's tool passes PRNGKey(11) to every step. It runs on
the card unless `--device cpu`; `--tiny` is the CPU test geometry (64^2,
total_step 10, LoRA 4, tiny towers).

    python -m comat_tpu_torch.tools.stability_run [--steps 10] [--batch-size 4]
        [--device cpu --tiny]
"""

from __future__ import annotations

import argparse
import math
import statistics
import time
from typing import Dict, List, Optional

import numpy as np

CAPTION_TOKENS = 32


def bench_prompts(batch_size: int) -> List[str]:
    """bench.py's prompts."""
    return [f"a photo of a red car and {i} blue birds" for i in range(batch_size)]


STEP_SEED = 11


def build(batch_size: int, device=None, tiny: bool = False):
    """(pipeline, BLIP, train_step, state, batch, TrainConfig) of bench.py's
    default step at `batch_size`."""
    from comat_tpu_torch.config import BLIPConfig
    from comat_tpu_torch.losses.caption_reward import build_caption_batch
    from comat_tpu_torch.models.blip import make_blip
    from comat_tpu_torch.models.pipeline import DiffusionPipeline, make_pipeline_config
    from comat_tpu_torch.text.tokenizer import HashTokenizer
    from comat_tpu_torch.training import train_step as ts

    resolution = 64 if tiny else 512
    pcfg = make_pipeline_config("sd_1_5", lora_rank=4 if tiny else 128,
                                resolution=resolution, tiny=tiny)
    bcfg = BLIPConfig.tiny() if tiny else BLIPConfig.large()
    pipe = DiffusionPipeline(pcfg, device, seed=0)
    blip = make_blip(bcfg, pipe.device, seed=1)
    tcfg = ts.TrainConfig(total_step=10 if tiny else 50, K=5, resolution=resolution)
    prompts = bench_prompts(batch_size)
    tok = HashTokenizer(pcfg.text.vocab_size)
    enc, null = tok(prompts), tok([""] * batch_size)
    cap = build_caption_batch(HashTokenizer(bcfg.vocab_size), prompts)

    def pad(a, value):
        return np.pad(a, ((0, 0), (0, CAPTION_TOKENS - a.shape[1])), constant_values=value)

    batch = {"input_ids": enc["input_ids"], "eos_positions": enc["eos_positions"],
             "null_ids": null["input_ids"], "caption_ids": pad(cap["input_ids"], 0),
             "caption_mask": pad(cap["attention_mask"], 0),
             "caption_labels": pad(cap["labels"], -100)}
    state = ts.init_train_state(pipe, tcfg)
    return pipe, blip, ts.make_train_step(pipe, blip, tcfg), state, batch, tcfg


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Run and print the steps; returns {"seconds", "losses", "rewards"
    (a step each), "steady_s" (mean from step 2), "images_per_s",
    "all_finite", "device"}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--device", default=None, help="default cuda")
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)
    if args.steps < 3:
        raise ValueError("--steps must be at least 3: the steady state starts at step 2")
    import torch

    pipe, _, step, state, batch, _ = build(args.batch_size, args.device, args.tiny)
    seconds, losses, rewards = [], [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        gen = torch.Generator(device=pipe.device).manual_seed(STEP_SEED)
        state, m = step(state, batch, generator=gen)   # host floats: synchronised
        seconds.append(time.perf_counter() - t0)
        losses.append(m["step_loss"])
        rewards.append(m["reward_blip"])
        print(f"step {i}: {seconds[-1]:.3f}s loss={losses[-1]:.4f} "
              f"reward={rewards[-1]:.4f}", flush=True)
    steady = statistics.fmean(seconds[2:])
    finite = all(math.isfinite(x) for x in losses)
    device = (torch.cuda.get_device_name(pipe.device) if pipe.device.type == "cuda"
              else "cpu")
    print(f"steady-state: {steady:.3f}s/step ({args.batch_size / steady:.3f} imgs/s "
          f"on {device}), all finite: {finite}", flush=True)
    return {"seconds": seconds, "losses": losses, "rewards": rewards, "steady_s": steady,
            "images_per_s": args.batch_size / steady, "all_finite": finite,
            "device": device}


if __name__ == "__main__":
    main()
