"""Run one cell of the benchmark of comat_tpu_torch once.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is `benchmark/workloads/<name>.json`; its driver
(`benchmark/drivers/<kind>.py`) sets the program up, warms it up, measures
for --seconds and checks what the timed path produced against the plain
reference. --trace 0 reports the cell's end-to-end metrics, --trace 1 its
per-layer metrics from a traced window. The last line of standard output
is the result, one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.

It runs on the NVIDIA card it is started on and exits with a non-zero
code, printing no result, when there is no card or too few, or when a
module of JAX or of the JAX package is loaded once the window has closed.
Kernels and caches are built under build/ in the checkout, once.

--control puts a lower precision in the program's place: "fp8", the
reference computed in float8; "pass1_int8", the program's own W8A8 pass
1. --fault plants a fault in the timed path. Both are for reading the
checks' limits, never part of a cell's run.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_JAX", "0")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)

from benchmark import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("fp8", "pass1_int8"), default=None)
    p.add_argument("--fault", choices=("frozen", "half_batch", "token"), default=None)
    return p.parse_args(argv)


def execute(args, device, t0: float) -> harness.Result:
    """One run of the cell on `device`, after the look for a card."""
    wl = harness.cell(args.workload)
    ctx = types.SimpleNamespace(
        workload=args.workload, wl=wl, spec=harness.benchmark_spec(), seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), control=args.control,
        fault=args.fault, device=device, t0=t0)
    driver = harness.load_module(os.path.join(harness.HERE, "drivers", f"{wl['driver']}.py"),
                                 "bench_driver_" + wl["driver"])
    return driver.run(ctx)


def report(result: harness.Result) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    for name, c in result.checks.items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    harness.say(result.line())


def main(argv=None) -> int:
    args = parse(argv)
    wl = harness.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        harness.log(f"no result: the cell needs {wl['chips']} CUDA device(s), "
                    f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = execute(args, torch.device("cuda", 0), T0)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"no result: the run loaded {found} (JAX or the JAX package)")
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
