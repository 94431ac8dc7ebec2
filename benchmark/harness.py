"""What every cell of the benchmark shares: the files it is driven by,
the device's description, the clocks sampled beside the window, the
profiler's summary, the per-layer readers and the result line.

A cell is `workloads/<name>.json` (its configuration, its driver kind and
the driver's inputs), a configuration `configs/<name>.json`, a driver
`drivers/<kind>.py` with `run(ctx) -> Result`, and a per-layer metric
`metrics/<name>.py` with `read(trace) -> float | None`. They are found by
name: a new cell, configuration or metric is a new file and an entry in
BENCHMARK.json, never an edit of this one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "comat_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell(name: str) -> dict:
    """The workload file of cell `name`, with its configuration file's
    contents under "cfg"."""
    wl = load_json(HERE, "workloads", f"{name}.json")
    wl["cfg"] = load_json(HERE, "configs", f"{wl['config']}.json")
    return wl


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (`comat_tpu_torch` is not `comat_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def per_layer_metrics(spec: dict, workload: str):
    """The per-layer entries of BENCHMARK.json this cell reports."""
    out = []
    for m in spec.get("per_layer", []):
        if "workloads" in m and workload not in m["workloads"]:
            continue
        out.append(m)
    return out


def read_metrics(entries, trace) -> Dict[str, dict]:
    """Each metric's reader (`metrics/<name>.py`) over `trace`; a reader
    that finds nothing returns None and the metric is left out."""
    out = {}
    for m in entries:
        mod = load_module(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                          "bench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
        value = mod.read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


# ---------------------------------------------------------------- device

def device_info(torch, device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


class ClockSampler:
    """nvidia-smi's clocks, power and temperature of the card, sampled
    every second beside the window by one child process, which `stop`
    ends and waits for."""

    FIELDS = ("name", "clocks.sm", "clocks.mem", "power.draw", "power.limit",
              "temperature.gpu")

    def __init__(self, index: int):
        self.rows: List[List[str]] = []
        self.proc = None
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "-i", str(index), "--query-gpu=" + ",".join(self.FIELDS),
                 "--format=csv,noheader,nounits", "-lms", "1000"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for line in self.proc.stdout:
            self.rows.append([c.strip() for c in line.split(",")])

    def stop(self) -> str:
        """Ends the sampler; returns one line summarising the samples."""
        if self.proc is None:
            return "clocks: nvidia-smi not available"
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.thread.join(timeout=5)
        rows = [r for r in self.rows if len(r) == len(self.FIELDS)]
        if not rows:
            return "clocks: no samples"
        parts = [f"card {rows[0][0]}, {len(rows)} samples"]
        for i, field in enumerate(self.FIELDS[1:], start=1):
            vals = []
            for r in rows:
                try:
                    vals.append(float(r[i]))
                except ValueError:
                    pass
            if vals:
                parts.append(f"{field} min {min(vals)} median {statistics.median(vals)} "
                             f"max {max(vals)}")
        return "clocks: " + "; ".join(parts)


# ---------------------------------------------------------------- profile

class HostRanges:
    """Spans of the host's time, (start ns, end ns, label) on the
    monotonic clock: around whole steps ("step") and around the trainer's
    callables (`wrap`), recorded by the harness from outside the program."""

    def __init__(self):
        self.spans: List[tuple] = []
        self.on = False

    @contextlib.contextmanager
    def span(self, label: str):
        t0 = time.monotonic_ns()
        try:
            yield
        finally:
            if self.on:
                self.spans.append((t0, time.monotonic_ns(), label))

    def wrap(self, owner, attr: str, label: str) -> None:
        inner = getattr(owner, attr, None)
        if inner is None:
            return

        def wrapped(*a, **kw):
            with self.span(label):
                return inner(*a, **kw)

        setattr(owner, attr, wrapped)


@dataclasses.dataclass
class ProfileSummary:
    """The profiled steps, reduced: `window_s` their wall time (the host's
    step spans, first start to last end), `busy_s` the union of the
    device's kernels, copies and sets within it, `kernels` device seconds
    by name, `gaps` the device's idle gaps as (label, seconds), labelled by
    the host span (not a step) that covers most of the gap, `offset_ns`
    the shift that put the device's clock on the host's."""

    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: Dict[str, float] = dataclasses.field(default_factory=dict)
    gaps: List[tuple] = dataclasses.field(default_factory=list)
    steps: int = 0
    offset_ns: int = 0


def summarise_profile(prof, ranges: HostRanges) -> ProfileSummary:
    """Reduce a `torch.profiler.profile` of CUDA activity over whole steps
    with the host spans recorded beside it. The device's timestamps are
    put on the host's clock by aligning the last device activity's end with
    the end of the last step, which synchronises."""
    dev = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA" and not e.is_user_annotation():
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    steps = [(s, t) for s, t, n in ranges.spans if n == "step"]
    out = ProfileSummary(steps=len(steps))
    if not steps or not dev:
        return out
    w0, w1 = min(s for s, _ in steps), max(t for _, t in steps)
    out.offset_ns = w1 - max(t for _, t, _ in dev)
    dev = sorted((s + out.offset_ns, t + out.offset_ns, n) for s, t, n in dev)
    dev = [(max(s, w0), min(t, w1), n) for s, t, n in dev if t > w0 and s < w1]
    out.window_s = (w1 - w0) / 1e9
    for s, t, n in dev:
        out.kernels[n] = out.kernels.get(n, 0.0) + (t - s) / 1e9
    busy, cur_s, cur_t, gaps = 0, None, None, []
    prev_end = w0
    for s, t, _ in dev:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
            if s > prev_end:
                gaps.append((prev_end, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
        prev_end = max(prev_end, t)
    if cur_t is not None:
        busy += cur_t - cur_s
    if w1 > prev_end:
        gaps.append((prev_end, w1))
    out.busy_s = busy / 1e9
    spans = [(s, t, n) for s, t, n in ranges.spans if n != "step"]
    for g0, g1 in gaps:
        best, label = 0, "outside the harness's spans"
        for s, t, n in spans:
            ov = min(t, g1) - max(s, g0)
            if ov > best:
                best, label = ov, n
        out.gaps.append((label, (g1 - g0) / 1e9))
    return out


def breakdown(summary: ProfileSummary) -> dict:
    ops = sorted(summary.kernels.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary.gaps, key=lambda g: -g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


# ---------------------------------------------------------------- result

@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, dict]
    device: dict
    checks: Dict[str, dict]
    breakdown: Optional[dict] = None

    def line(self) -> str:
        obj = {"correct": self.correct, "attempted": self.attempted, "failed": self.failed,
               "metrics": self.metrics, "device": self.device}
        if self.breakdown is not None:
            obj["breakdown"] = self.breakdown
        obj["checks"] = self.checks
        return json.dumps(obj)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def say(*args) -> None:
    print(*args, flush=True)

