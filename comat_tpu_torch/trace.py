"""The step's trace: `PhaseClock`, the device's marks and the host's spans
on one clock.

A mark (`PhaseClock.mark`) records a CUDA event on the current stream
(the host clock on the CPU) and the host's `time.time_ns()` when it is
queued. A span (`PhaseClock.span`) records (name, start_ns, end_ns,
parent, kind) on `time.time_ns()`, the Unix-epoch clock that
`torch.profiler`'s events are on, so a profile of the device and the
spans line up without a shift (training/profile.py). A sync
(`PhaseClock.sync`) is a span of kind "sync" around a read that blocks on
the device, and the clock counts them. `PhaseClock.close` ends a step: it
records a last event, waits for it and reads `time.time_ns()`, the
anchor, which puts each mark's device time on the host's clock (the
anchor less the mark's elapsed time to the last event) and gives its
lead: how long the mark waited in the device's queue after the host
queued it. A lead of microseconds says the device had run dry and waited
on the host; one of milliseconds, that the host ran ahead.

The layers below the trainer (the sampler, the pipeline, the segmenter,
the optimizer) take marks, spans and syncs on the *active* clock through
this module's `mark`, `span` and `sync`, as
`torch.profiler.record_function` does, so they need no clock argument.
A tally (`PhaseClock.tally`, `tally`) counts events of a name on the
active clock: pass 1's guided calls that replayed a CUDA graph
("pass1_graph") or ran eagerly ("pass1_eager"), and the graph captures
("pass1_capture"; `diffusion/pass1_graph.py`).
`PhaseClock.active()` makes a clock the active one for a block and
restores the one before it on leaving; with no active clock `mark`,
`span` and `sync` do nothing. The active clock is one for the process,
not for a thread: autograd runs a CUDA backward on a thread of its own,
and the marks taken there land on the step's clock. A span costs two
`time_ns()` reads and a list append (~2.5 us on the H100's host), and
takes no synchronise and no device memory.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch


class Span(NamedTuple):
    """One span of the host's time, on `time.time_ns()`."""

    name: str
    start_ns: int
    end_ns: int
    parent: int             # index in `PhaseClock.spans` of the span open at its start, or -1
    kind: str = "span"      # "sync": a read that blocks on the device


class PhaseClock:
    """Marks on the device's timeline (CUDA events; the host clock on the
    CPU), read after the step has synchronised, and the host's spans.

    A name may be marked more than once. `seconds(a, b)` spans the last
    mark `a` to the last mark `b` (0 when either was not marked: a stage
    the step did not run); `seconds(name)` sums the spans between the
    marks `name<` and `name>` taken in pairs (the backward of each replay
    op, for instance); `span_seconds()` runs from the first mark to the
    last. These are stream seconds: the elapsed time between two events
    on the stream, the device's idle time between them included.
    `probe`, when given, is called at each mark (e.g. to read kernel
    launch counters), and `counts` takes the differences of its readings
    over the same spans.

    `spans` holds the host's spans in the order they began (a span still
    open is None); `n_syncs` counts the syncs, one a blocking read; `tallies`
    counts the tallied events by name. `leads_ms(*names)` gives
    the lead of each mark of those names once `close()` has run (0 on the
    CPU, where the host's clock is the device's)."""

    def __init__(self, device: torch.device,
                 probe: Optional[Callable[[], Dict[str, int]]] = None):
        self.cuda = device.type == "cuda"
        self.probe = probe
        # name -> [(stamp, probe reading, host ns when queued)]
        self.marks: Dict[str, List[Tuple[object, Optional[Dict[str, int]], int]]] = {}
        self.stamps: List[object] = []      # every mark's stamp, in order
        self.spans: List[Optional[Span]] = []
        self.n_syncs = 0
        self.tallies: Dict[str, int] = {}
        self.anchor_ns: Optional[int] = None
        self._open: List[int] = []
        self._last = None

    def mark(self, name: str) -> None:
        if self.cuda:
            stamp = torch.cuda.Event(enable_timing=True)
            host = time.time_ns()       # as the record is queued
            stamp.record()
        else:
            stamp = host = time.time_ns()
        reading = self.probe() if self.probe is not None else None
        self.marks.setdefault(name, []).append((stamp, reading, host))
        self.stamps.append(stamp)

    def _elapsed_s(self, sa, sb) -> float:
        return sa.elapsed_time(sb) / 1e3 if self.cuda else (sb - sa) / 1e9

    def _pairs(self, a: str, b: Optional[str]):
        if b is not None:
            if a not in self.marks or b not in self.marks:
                return []       # a stage this step did not run
            return [(self.marks[a][-1], self.marks[b][-1])]
        begins, ends = self.marks.get(a + "<", []), self.marks.get(a + ">", [])
        if len(begins) != len(ends):
            raise RuntimeError(f"span {a}: {len(begins)} begins, {len(ends)} ends")
        return list(zip(begins, ends))

    def seconds(self, a: str, b: Optional[str] = None) -> float:
        return sum((self._elapsed_s(sa[0], sb[0]) for sa, sb in self._pairs(a, b)), 0.0)

    def span_seconds(self) -> float:
        """Stream seconds from the clock's first mark to its last."""
        if not self.stamps:
            return 0.0
        return self._elapsed_s(self.stamps[0], self.stamps[-1])

    def counts(self, a: str, b: Optional[str] = None) -> Dict[str, int]:
        total: Dict[str, int] = {}
        for (_, ra, _), (_, rb, _) in self._pairs(a, b):
            for k in rb:
                total[k] = total.get(k, 0) + rb[k] - ra[k]
        return total

    @contextlib.contextmanager
    def span(self, name: str, kind: str = "span"):
        """Record the block as a span `name`, a child of the span open
        when it began."""
        i = len(self.spans)
        parent = self._open[-1] if self._open else -1
        self.spans.append(None)
        self._open.append(i)
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans[i] = Span(name, start, time.time_ns(), parent, kind)
            self._open.pop()

    def sync(self, site: str):
        """A span of kind "sync" named `site`, around one read that blocks
        on the device (a copy to or from pageable host memory, a scalar
        read); counted in `n_syncs`. A site that reads n times takes n
        syncs, so that `n_syncs` counts the blocking calls."""
        self.n_syncs += 1
        return self.span(site, kind="sync")

    def tally(self, name: str) -> None:
        """Count one event `name` in `tallies`."""
        self.tallies[name] = self.tallies.get(name, 0) + 1

    def close(self) -> None:
        """End the step: record a last event, wait for it and read the
        anchor, `time.time_ns()`, within the wait's return latency of that
        event's device time whether the device was busy or idle. A sync of
        its own ("close")."""
        with self.sync("close"):
            if self.cuda:
                self._last = torch.cuda.Event(enable_timing=True)
                self._last.record()
                self._last.synchronize()
            self.anchor_ns = time.time_ns()

    def leads_ms(self, *names: str) -> List[float]:
        """Milliseconds from the host's queueing of each mark `names` to the
        device's reaching it, after `close()`."""
        if self.anchor_ns is None:
            raise RuntimeError("leads are read after close()")
        out = []
        for name in names:
            for stamp, _, host in self.marks.get(name, ()):
                device = (self.anchor_ns - stamp.elapsed_time(self._last) * 1e6
                          if self.cuda else host)
                out.append((device - host) / 1e6)
        return out

    def host_seconds(self, name: str) -> float:
        """Host seconds of the closed spans `name`, summed."""
        return sum(s.end_ns - s.start_ns for s in self.spans
                   if s is not None and s.name == name) / 1e9

    @contextlib.contextmanager
    def active(self):
        """Make this clock the one that `span` and `sync` below act on."""
        global _active
        previous, _active = _active, self
        try:
            yield self
        finally:
            _active = previous


_active: Optional[PhaseClock] = None
_NOTHING = contextlib.nullcontext()


def current() -> Optional[PhaseClock]:
    """The active clock, or None."""
    return _active


def mark(name: str) -> None:
    """`PhaseClock.mark` on the active clock; nothing without one."""
    if _active is not None:
        _active.mark(name)


def tally(name: str) -> None:
    """`PhaseClock.tally` on the active clock; nothing without one."""
    if _active is not None:
        _active.tally(name)


def span(name: str):
    """`PhaseClock.span` on the active clock; nothing without one."""
    return _active.span(name) if _active is not None else _NOTHING


def sync(site: str):
    """`PhaseClock.sync` on the active clock; nothing without one."""
    return _active.sync(site) if _active is not None else _NOTHING
