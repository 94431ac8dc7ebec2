"""Whether a step of the trainer repeats bit for bit on the card.

    python -m comat_tpu_torch.tools.probe_step_determinism [--steps 1]

Runs `comat_tpu_torch.train.main` twice from the same seed with the flags
of comat_tpu_torch/scripts/sd15.sh (the launcher's own defaults, 512^2,
batch 4, --gradient_checkpointing), --max_train_steps N and no validation
image, each into a directory of its own under build/, and compares the two
runs' last checkpoints: every G and D trainable tensor, every AdamW
moment, the generator state and the step loss. It does so in three modes:
as the trainer runs by default; with cuDNN's deterministic algorithms;
and with those and `torch.use_deterministic_algorithms(True,
warn_only=True)`, where it prints each operation PyTorch flags as having
no deterministic implementation on the card. Prints the card's name and
power limit first, then per mode the largest |delta|, the tensor it is in
and the step's wall seconds of each run. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import warnings

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LAUNCHER = os.path.join(REPO, "comat_tpu_torch", "scripts", "sd15.sh")
MODES = ("default", "cudnn_deterministic", "deterministic_algorithms")


def _set_mode(mode: str) -> None:
    torch.backends.cudnn.deterministic = mode != "default"
    torch.use_deterministic_algorithms(mode == "deterministic_algorithms",
                                       warn_only=True)


def _run(argv, out):
    from comat_tpu_torch.train import main

    shutil.rmtree(out, ignore_errors=True)
    trainer = main(argv + ["--output_dir", out])
    step = trainer.global_step
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    state = torch.load(os.path.join(out, f"checkpoint-{step}", "state.pt"),
                       map_location="cpu", weights_only=True)
    return state, rows


def _diffs(a, b):
    out = {}
    for key in ("trainable", "d_trainable"):
        for n, t in (a.get(key) or {}).items():
            out[f"{key}.{n}"] = (t.float() - b[key][n].float()).abs().max().item()
    for key in ("optimizer", "d_optimizer"):
        if a.get(key) is None:
            continue
        sa, sb = a[key]["adam"]["state"], b[key]["adam"]["state"]
        for i in sa:
            for m, t in sa[i].items():
                if torch.is_tensor(t):
                    out[f"{key}.{i}.{m}"] = (t.float() - sb[i][m].float()).abs().max().item()
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=1)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("probe_step_determinism: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from comat_tpu_torch.ops import _build
    from comat_tpu_torch.training.arguments import launcher_argv

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"cuDNN {torch.backends.cudnn.version()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(["flash_fwd", "flash_bwd", "conv3x3", "conv3x3_dw"])
    argv = launcher_argv(LAUNCHER)
    i = argv.index("--training_prompts") + 1
    argv[i] = os.path.join(REPO, argv[i])
    argv += ["--max_train_steps", str(args.steps), "--num_validation_images", "0"]
    work = os.path.join(REPO, "build", "probe_step_determinism")
    for mode in MODES:
        _set_mode(mode)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            a, rows_a = _run(argv, os.path.join(work, "a"))
            b, rows_b = _run(argv, os.path.join(work, "b"))
        flagged = sorted({str(w.message).splitlines()[0][:200] for w in caught
                          if "deterministic" in str(w.message)})
        d = _diffs(a, b)
        worst = max(d, key=d.get)
        same = (max(d.values()) == 0.0 and torch.equal(a["generator"], b["generator"])
                and [r["step_loss"] for r in rows_a] == [r["step_loss"] for r in rows_b])
        print(f"{mode}: {len(d)} tensors after {args.steps} step(s), largest |delta| "
              f"{d[worst]:.3e} ({worst}); {sum(v > 0 for v in d.values())} differ; "
              f"bit for bit: {same}; step loss {[r['step_loss'] for r in rows_a]} / "
              f"{[r['step_loss'] for r in rows_b]}; s/step wall "
              f"{[round(r['sec_per_step'], 3) for r in rows_a]} / "
              f"{[round(r['sec_per_step'], 3) for r in rows_b]}", flush=True)
        for msg in flagged:
            print(f"  flagged: {msg}", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
