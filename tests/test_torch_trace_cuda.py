"""The step's trace on the card: the anchor of `PhaseClock.close` and the
leads it gives (a mark queued behind a sleeping kernel leads by the
sleep, less the host's time between; a mark on an idle device hardly at
all), and the shared clock of a profile and the spans (every kernel
lies inside the span that launched it, on `time.time_ns()`'s clock, with
no shift).

and that each blocking call of a step lies in a named sync site and is
counted there once (a tiny full-recipe step with Grounded-SAM under
`torch.cuda.set_sync_debug_mode`).

These tests need an NVIDIA card and skip without one. The file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_trace_cuda.py
"""


import collections
import contextlib
import warnings

import pytest
import torch

from comat_tpu_torch import trace
from comat_tpu_torch.trace import PhaseClock
from comat_tpu_torch.training import profile


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.cuda.synchronize()
    return torch.device("cuda")


def _cycles_for_ms(ms: float) -> int:
    """`torch.cuda._sleep` cycles for about `ms` milliseconds on this card,
    read after a first sleep has brought its clock up."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(2):
        a.record()
        torch.cuda._sleep(50_000_000)
        b.record()
        b.synchronize()
    return int(50_000_000 * ms / a.elapsed_time(b))


@pytest.mark.cuda
def test_a_mark_behind_a_sleep_leads_by_the_sleep_less_the_host_time(card):
    cycles = _cycles_for_ms(50.0)
    torch.cuda.synchronize()
    clock = PhaseClock(card)
    clock.mark("idle")
    torch.cuda._sleep(cycles)
    clock.mark("behind")
    clock.close()
    slept_ms = clock.seconds("idle", "behind") * 1e3
    (_, _, h_idle), = clock.marks["idle"]
    (_, _, h_behind), = clock.marks["behind"]
    idle, behind = clock.leads_ms("idle", "behind")
    print(f"slept {slept_ms:.4f} ms, host between {(h_behind - h_idle) / 1e6:.4f} ms, "
          f"leads: idle {idle:.4f} ms, behind {behind:.4f} ms")
    # the anchor: both leads carry the same error, so the mark behind the
    # sleep leads by the sleep less the host's time between the marks,
    # plus the idle mark's lead (the device's response from idle)
    assert behind == pytest.approx(slept_ms - (h_behind - h_idle) / 1e6 + idle, abs=0.1)
    assert 30.0 < slept_ms < 80.0
    assert 0.0 <= idle < 0.01 * slept_ms


@pytest.mark.cuda
def test_kernels_lie_in_the_spans_that_launched_them_on_one_clock(card):
    x = torch.randn(2048, 2048, device=card)
    x @ x
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    clock = PhaseClock(card)
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        with clock.active(), trace.span("step"):
            for _ in range(4):
                with trace.span("work"):
                    y = x @ x
                    torch.cuda._sleep(2_000_000)
                    y.add_(1)
            clock.close()
    events = profile.device_events(prof)
    (step,) = [s for s in clock.spans if s.name == "step"]
    works = [s for s in clock.spans if s.name == "work"]
    assert len(events) >= 12
    launched = [e for e in events if e[3] != e[0]]
    print(f"{len(events)} device events, {len(launched)} with a launch found; first "
          f"kernel {(events[0][0] - step.start_ns) / 1e3:.1f} us after the step began, last "
          f"ends {(clock.anchor_ns - events[-1][1]) / 1e3:.1f} us before the anchor")
    for start, end, name, launch in events:
        assert step.start_ns <= launch <= start < end <= clock.anchor_ns + 100_000, name
        if launch != start:
            assert any(w.start_ns <= launch <= w.end_ns for w in works), name
    summary = profile.summarise(events, clock.spans)
    own = sum(r["idle_own_s"] for r in summary["spans"].values())
    assert own == pytest.approx(summary["idle_s"], rel=1e-9)
    assert summary["spans"]["work"]["kernels"] >= 12


@pytest.mark.cuda
def test_every_blocking_call_of_a_step_is_one_counted_sync(card, tmp_path, monkeypatch):
    """The second step of a tiny trainer (GAN, attribute concentration,
    Grounded-SAM at tiny width) under `set_sync_debug_mode("error")`,
    which raises at a blocking call outside every sync site. Inside a
    site the mode is "warn": the step's blocking calls, counted by their
    warnings, are its syncs but the closing wait (an event's synchronise,
    which the mode does not see), one in each, so `n_syncs` counts
    blocking calls."""
    from comat_tpu_torch.segmentation import interface
    from comat_tpu_torch.segmentation.fastsam import YoloSegConfig
    from comat_tpu_torch.segmentation.gdino import GDinoConfig
    from comat_tpu_torch.segmentation.grounded_sam import GroundedSAMSegmenter
    from comat_tpu_torch.training.arguments import parse_args
    from comat_tpu_torch.training.trainer import Trainer

    prompts = ["a red car and a blue bird", "two green cats on a mat"]
    (tmp_path / "p.txt").write_text("\n".join(prompts) + "\n")
    # --tiny_models builds the center prior: tiny Grounded-SAM takes its place
    monkeypatch.setattr(interface, "CenterPriorSegmenter", lambda: GroundedSAMSegmenter(
        YoloSegConfig.tiny(), GDinoConfig.tiny(), device=card, seed=7,
        box_threshold=0.0, text_threshold=0.0))
    trainer = Trainer(parse_args([
        "--training_prompts", str(tmp_path / "p.txt"), "--output_dir", str(tmp_path / "out"),
        "--pretrain_model_name", "sd_1_5_attrcon", "--tiny_models", "--device", "cuda",
        "--train_batch_size", "2", "--seed", "0", "--total_step", "4", "--K", "2",
        "--attrcon_train_steps", "1", "--resolution", "64", "--lora_rank", "4",
        "--gan_loss", "--report_to", "none"]))
    assert isinstance(trainer.seg_holder.segmenter, GroundedSAMSegmenter)
    trainer.train_one(prompts)
    torch.cuda.synchronize()

    sites = collections.Counter()       # syncs by site
    inside = collections.Counter()      # blocking calls inside them
    caught = {"log": []}
    seen = set()                        # the warnings raised inside a sync
    plain = PhaseClock.sync

    def blocking(log):      # the mode's own warnings, not its notice that it is a prototype
        return [w for w in log if "called a synchronizing CUDA operation" in str(w.message)]

    @contextlib.contextmanager
    def allowed(self, site):
        sites[site] += 1
        mode, before = torch.cuda.get_sync_debug_mode(), len(caught["log"])
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with plain(self, site):
                yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            new = blocking(caught["log"][before:])
            inside[site] += len(new)
            seen.update(map(id, new))

    monkeypatch.setattr(PhaseClock, "sync", allowed)
    with warnings.catch_warnings(record=True) as caught["log"]:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("error")
        try:
            m = trainer.train_one(prompts)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    calls = blocking(caught["log"])
    outside = [f"{w.filename}:{w.lineno}" for w in calls if id(w) not in seen]
    print(f"{len(calls)} blocking calls, n_syncs {m['n_syncs']:.0f}; site: syncs / blocking "
          "calls inside: " + ", ".join(f"{k} {n}/{inside[k]}" for k, n in sites.items())
          + f"; outside every site: {outside}")
    assert m["n_syncs"] == sum(sites.values())
    assert sites["close"] == 1 and sites["segment.wait"] >= 4
    assert {k: n for k, n in inside.items() if k != "close"} == {
        k: n for k, n in sites.items() if k != "close"}
    assert outside == [] and len(calls) == m["n_syncs"] - sites["close"]
