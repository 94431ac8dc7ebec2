"""A copy of the benchmark with a tiny cell added, run on the CPU.

`make_copy(root)` copies benchmark/ and BENCHMARK.json under `root`, links
the program, writes a short corpus and adds `configs/tiny*.json` and
`workloads/tiny*-train.json`: SD1.5 and SDXL trainer cells at the
trainer's --tiny_models geometry, fp32 on the CPU, with the sd15-train
cell's limits; the copy's BENCHMARK.json lists them under its per-layer
metrics. `run_cell(root, ...)` runs one cell in a fresh process there,
through the harness's own entry after the look for a card, and returns
what it printed."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_FLAGS = ["--tiny_models", "--device", "cpu", "--resolution", "128",
              "--train_batch_size", "2", "--total_step", "10", "--K", "2", "--lora_rank", "4"]


def make_copy(root: str) -> str:
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for m in spec["per_layer"]:
        m["workloads"] = m.get("workloads", []) + ["tiny-train", "tinyxl-train"]
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))
    os.symlink(os.path.join(REPO, "comat_tpu_torch"), os.path.join(root, "comat_tpu_torch"))
    os.makedirs(os.path.join(root, "corpus"))
    with open(os.path.join(REPO, "collected_data", "abc5k.txt")) as f:
        lines = [next(f) for _ in range(64)]
    with open(os.path.join(root, "corpus", "tiny.txt"), "w") as f:
        f.writelines(lines)
    b = os.path.join(root, "benchmark")
    cfg = json.load(open(os.path.join(b, "configs", "sd15.json")))
    tiny = dict(cfg, name="tiny")
    tiny["pipeline"] = {"name": "sd_1_5_attrcon",
                        "capture_layers": ["mid_2", "up_4", "up_8", "up_16"]}
    tiny["unet"] = dict(cfg["unet"], block_out_channels=[32, 64, 64, 64],
                        attention_heads=[2, 2, 2, 2], cross_attention_dim=32, norm_num_groups=8)
    tiny["vae"] = dict(cfg["vae"], block_out_channels=[16, 32, 32, 32], layers_per_block=1,
                       norm_num_groups=8)
    tiny["text"] = dict(cfg["text"], vocab_size=1000, hidden_size=32, intermediate_size=64,
                        num_hidden_layers=2, num_attention_heads=2)
    tiny["blip"] = dict(cfg["blip"], image_size=64, vision_hidden_size=32, vision_layers=2,
                        vision_heads=2, vision_intermediate_size=64, vocab_size=1000,
                        text_hidden_size=32, text_layers=2, text_heads=2,
                        text_intermediate_size=64)
    xl = dict(tiny, name="tinyxl")
    xl["pipeline"] = {"name": "sdxl_attrcon_unet", "capture_layers": ["mid_4", "up_4", "up_8"]}
    # SDXL's UNet topology (stabilityai/stable-diffusion-xl-base-1.0) at tiny widths
    xl["unet"] = dict(cfg["unet"], block_out_channels=[32, 64, 64],
                      down_block_types=["down", "cross", "cross"],
                      up_block_types=["cross", "cross", "up"],
                      transformer_layers_per_block=[0, 1, 2], attention_heads=[2, 2, 2],
                      cross_attention_dim=64, norm_num_groups=8,
                      addition_embed_type="text_time", addition_time_embed_dim=32,
                      projection_class_embeddings_input_dim=224)
    xl["text2"] = dict(tiny["text"])
    xl["d_unet"] = tiny["unet"]
    wl = json.load(open(os.path.join(b, "workloads", "sd15-train.json")))
    for c, launcher in ((tiny, "sd15.sh"), (xl, "sdxl.sh")):
        json.dump(c, open(os.path.join(b, "configs", f"{c['name']}.json"), "w"))
        json.dump(dict(wl, name=f"{c['name']}-train", config=c["name"], resolution=128,
                       latent_files=4, corpus="corpus/tiny.txt", flags=TINY_FLAGS,
                       launcher=f"comat_tpu_torch/scripts/{launcher}", trace_steps=1),
                  open(os.path.join(b, "workloads", f"{c['name']}-train.json"), "w"))
    return root


def limits() -> dict:
    """The sd15-train cell's limits, which the tiny cells take."""
    with open(os.path.join(REPO, "benchmark", "workloads", "sd15-train.json")) as f:
        return json.load(f)["limits"]


SCRIPT = """
import json, sys, time
t0 = time.perf_counter()
import torch
torch.set_num_threads(2)
from benchmark import harness, run
args = run.parse(sys.argv[1:])
res = run.execute(args, torch.device("cpu"), t0)
mods = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"forbidden": harness.forbidden_modules(), "top_level": mods}))
run.report(res)
"""


def run_cell(root: str, workload: str, seed: int = 2147483711, trace: int = 0, *extra):
    """(the result line's object, the run's top-level module names and
    forbidden ones, its standard error)."""
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", SCRIPT, "--workload", workload, "--seed",
                        str(seed), "--seconds", "1", "--trace", str(trace), *extra],
                       cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    lines = p.stdout.strip().splitlines()
    return json.loads(lines[-1]), json.loads(lines[-2]), p.stderr
