"""The trainer's --profile_dir: the device's activity from `torch.profiler`
beside the profiled steps' spans (`comat_tpu_torch.trace`), both on
`time.time_ns()`'s clock, so neither is shifted onto the other.

`write_profile` writes `trace.json`, the profiler's chrome trace with the
spans merged in as a track of their own, and `profile_summary.json`,
`summarise`'s reduction: for each span name its count, host and self
seconds, the device's busy and idle seconds inside it, the kernels
launched in it and the device seconds by kind of kernel (`KINDS`). Each
idle nanosecond of the window, the profiled steps' first start to their
last end, is put down to exactly one span, the innermost that covers it,
else to "outside"; the longest idle gaps are listed with that span.
"""

from __future__ import annotations

import bisect
import json
import os
import re
from typing import Dict, Iterable, List, Sequence, Tuple

from comat_tpu_torch.trace import PhaseClock, Span

# A kind of kernel by lowercase substrings of its name, the first kind
# that matches winning: cuDNN's implicit-GEMM convolutions ("fprop",
# "dgrad", "wgrad") count as conv before "gemm" can take them, and a
# group norm's apply, an elementwise kernel over a norm functor, as norm.
KINDS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("attention", ("flash_fwd", "flash_bwd", "fmha", "attention", "softmax")),
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "winograd")),
    ("gemm", ("gemm", "nvjet", "cutlass", "cublas", "xmma", "matmul")),
    ("norm", ("groupnorm", "group_norm", "layernorm", "layer_norm", "batchnorm",
              "batch_norm", "moments", "welford", "fusedparams")),
    ("elementwise/copy", ("elementwise", "copy", "memcpy", "memset", "fill",
                          "nchwtonhwc", "nhwctonchw", "transpose", "catarray", "index",
                          "gather", "scatter", "quant")),
)
OTHER = "other"
OUTSIDE = "outside"
N_GAPS = 20     # the longest idle gaps listed


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, patterns in KINDS:
        if any(p in low for p in patterns):
            return kind
    return OTHER


# A device event: (start ns, end ns, name, launch ns), the launch being the
# host's runtime call that queued it (its start where the profile has none).
DeviceEvent = Tuple[int, int, str, int]


def device_events(prof) -> List[DeviceEvent]:
    """The device's kernels, copies and sets in a `torch.profiler.profile`,
    each with its launch found by the runtime call's correlation id."""
    events = list(prof.profiler.kineto_results.events())
    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type().name == "CPU" and e.correlation_id()}
    out = []
    for e in events:
        if e.device_type().name == "CUDA" and not e.is_user_annotation():
            start = e.start_ns()
            out.append((start, start + e.duration_ns(), e.name(),
                        launches.get(e.correlation_id(), start)))
    return out


def spans_of(clocks: Iterable[PhaseClock]) -> List[Span]:
    """The closed spans of several clocks in one list, each parent index
    moved to the span's place in it."""
    out: List[Span] = []
    for clock in clocks:
        place = {}
        for i, s in enumerate(clock.spans):
            if s is not None:
                place[i] = len(out)
                out.append(s._replace(parent=place.get(s.parent, -1)))
    return out


class _Busy:
    """The union of intervals, and the part of any [a, b) it covers."""

    def __init__(self, intervals: Sequence[Tuple[int, int]]):
        merged: List[List[int]] = []
        for s, t in sorted(intervals):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            elif t > s:
                merged.append([s, t])
        self.starts = [s for s, _ in merged]
        self.ends = [t for _, t in merged]
        self.before = [0]
        for s, t in merged:
            self.before.append(self.before[-1] + t - s)

    def _upto(self, x: int) -> int:
        k = bisect.bisect_right(self.starts, x) - 1
        if k < 0:
            return 0
        return self.before[k] + min(x, self.ends[k]) - self.starts[k]

    def within(self, a: int, b: int) -> int:
        return self._upto(b) - self._upto(a) if b > a else 0

    def gaps(self, a: int, b: int) -> List[Tuple[int, int]]:
        """The idle intervals inside [a, b)."""
        out, t = [], a
        k = max(bisect.bisect_right(self.starts, a) - 1, 0)
        for s, e in zip(self.starts[k:], self.ends[k:]):
            if s >= b:
                break
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if b > t:
            out.append((t, b))
        return out


def _owners(spans: Sequence[Span], w0: int, w1: int) -> List[Tuple[int, int, int]]:
    """[w0, w1) cut into (start, end, span index) pieces, each piece owned
    by the innermost span that covers it (-1: none)."""
    children: Dict[int, List[int]] = {}
    for i, s in enumerate(spans):
        children.setdefault(s.parent, []).append(i)
    pieces: List[Tuple[int, int, int]] = []

    def fill(lo: int, hi: int, owner: int) -> None:
        t = lo
        for k in sorted(children.get(owner, ()), key=lambda k: spans[k].start_ns):
            a, b = max(spans[k].start_ns, t), min(spans[k].end_ns, hi)
            if b <= a:
                continue
            if a > t:
                pieces.append((t, a, owner))
            fill(a, b, k)
            t = b
        if hi > t:
            pieces.append((t, hi, owner))

    fill(w0, w1, -1)
    return pieces


def summarise(events: Sequence[DeviceEvent], spans: Sequence[Span]) -> dict:
    """Reduce the device's events and the host's spans (on one clock) over
    the window of the top-level spans, first start to last end. Events are
    clipped to the window, and to each span where they are counted inside
    it. Returns {window_s, busy_s, idle_s, idle_pct, kernels, spans: {name
    or "outside": {count, host_s, self_s, busy_s, idle_s, idle_own_s,
    kernels, device_s: {kind: seconds}}}, gaps: the N_GAPS longest idle
    gaps as [[owner, seconds], ...]},
    where `idle_s` is the idle time inside the spans of that name and
    `idle_own_s` the idle time put down to them as the innermost span, so
    that the `idle_own_s` of all names and "outside" sum to `idle_s` of the
    window, and busy plus idle is the window."""
    tops = [s for s in spans if s.parent < 0]
    if not tops:
        return {"window_s": 0.0, "busy_s": 0.0, "idle_s": 0.0, "idle_pct": 0.0,
                "kernels": 0, "spans": {}, "gaps": []}
    w0, w1 = min(s.start_ns for s in tops), max(s.end_ns for s in tops)
    events = sorted((max(s, w0), min(t, w1), n, launch) for s, t, n, launch in events
                    if t > w0 and s < w1)
    busy = _Busy([(s, t) for s, t, _, _ in events])
    starts = [s for s, _, _, _ in events]
    longest = max((t - s for s, t, _, _ in events), default=0)
    launches = sorted(launch for _, _, _, launch in events)

    rows: Dict[str, dict] = {}

    def row(name: str) -> dict:
        return rows.setdefault(name, {"count": 0, "host_s": 0.0, "self_s": 0.0,
                                      "busy_s": 0.0, "idle_s": 0.0, "idle_own_s": 0.0,
                                      "kernels": 0, "device_s": {}})

    child_ns: Dict[int, int] = {}
    for s in spans:
        if s.parent >= 0:
            child_ns[s.parent] = child_ns.get(s.parent, 0) + s.end_ns - s.start_ns
    for i, s in enumerate(spans):
        a, b = max(s.start_ns, w0), min(s.end_ns, w1)
        r = row(s.name)
        r["count"] += 1
        r["host_s"] += (s.end_ns - s.start_ns) / 1e9
        r["self_s"] += (s.end_ns - s.start_ns - child_ns.get(i, 0)) / 1e9
        on = busy.within(a, b)
        r["busy_s"] += on / 1e9
        r["idle_s"] += (max(b - a, 0) - on) / 1e9
        r["kernels"] += bisect.bisect_left(launches, b) - bisect.bisect_left(launches, a)
        kinds = r["device_s"]
        for k in range(bisect.bisect_left(starts, a - longest), bisect.bisect_left(starts, b)):
            es, et, name, _ = events[k]
            overlap = min(et, b) - max(es, a)
            if overlap > 0:
                kind = kernel_kind(name)
                kinds[kind] = kinds.get(kind, 0.0) + overlap / 1e9

    gaps: List[Tuple[str, int]] = []
    idle_total = 0
    for lo, hi, owner in _owners(spans, w0, w1):
        name = spans[owner].name if owner >= 0 else OUTSIDE
        r = row(name)
        idle = (hi - lo) - busy.within(lo, hi)
        r["idle_own_s"] += idle / 1e9
        idle_total += idle
        if owner < 0:
            r["host_s"] += (hi - lo) / 1e9
            r["self_s"] += (hi - lo) / 1e9
            r["busy_s"] += busy.within(lo, hi) / 1e9
            r["idle_s"] += idle / 1e9
        gaps.extend((name, t - s) for s, t in busy.gaps(lo, hi))
    gaps.sort(key=lambda g: -g[1])
    window = w1 - w0
    return {"window_s": window / 1e9, "busy_s": (window - idle_total) / 1e9,
            "idle_s": idle_total / 1e9, "idle_pct": 100.0 * idle_total / window,
            "kernels": len(events), "spans": rows,
            "gaps": [[name, ns / 1e9] for name, ns in gaps[:N_GAPS]]}


def _merge_spans(path: str, spans: Sequence[Span]) -> None:
    """Append the spans to the chrome trace at `path` as complete events on
    a track of this process's own ("comat_tpu_torch spans"), on the trace's
    clock (microseconds from its `baseTimeNanoseconds`). The trace of four
    SD1.5 steps holds some 700,000 device events (~0.7 GB), so the spans
    go in before the list's closing bracket, the last one before the
    "traceName" that `export_chrome_trace` writes after it, and the file
    is never parsed whole."""
    with open(path, "rb") as f:
        head = f.read(4096)
    found = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    base = int(found.group(1)) if found else 0
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
               "args": {"name": "comat_tpu_torch spans"}}]
    events.extend({"ph": "X", "cat": s.kind, "name": s.name, "pid": pid, "tid": 0,
                   "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3}
                  for s in spans)
    with open(path, "rb+") as f:
        size = f.seek(0, os.SEEK_END)
        start = max(0, size - 65536)
        f.seek(start)
        tail = f.read()
        name = tail.rfind(b'"traceName"')
        close = tail.rfind(b"]", 0, name if name >= 0 else len(tail))
        if close < 0:
            raise ValueError(f"{path}: no traceEvents list at the end of the trace")
        f.seek(start + close)
        f.write(b",\n" + b",\n".join(json.dumps(e).encode() for e in events)
                + b"\n" + tail[close:])


def write_profile(prof, clocks: Sequence[PhaseClock], out_dir: str) -> Tuple[str, str]:
    """`prof` (stopped) and the clocks of the steps it covered into
    `out_dir`: trace.json, the profiler's chrome trace with the spans
    merged in (`_merge_spans`), and profile_summary.json (`summarise`,
    with the number of steps). Returns both paths."""
    os.makedirs(out_dir, exist_ok=True)
    spans = spans_of(clocks)
    trace_path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(trace_path)
    _merge_spans(trace_path, spans)
    summary = summarise(device_events(prof), spans)
    summary["steps"] = len(clocks)
    summary_path = os.path.join(out_dir, "profile_summary.json")
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=1)
    return trace_path, summary_path
