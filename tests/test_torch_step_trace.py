"""The step's trace (comat_tpu_torch/trace.py, training/profile.py): spans
and their parents, marks with host stamps, the leads on a scripted device
clock, the trainer step's traced outputs and its `sec_per_step` window,
the profile summary's accounting of idle time, the kernel kinds, and
--profile_dir's two files. All on the CPU; the leads on the card are
`tests/test_torch_trace_cuda.py`'s."""

import json
import math
import time
import types

import pytest
import torch

from comat_tpu_torch import trace
from comat_tpu_torch.trace import PhaseClock, Span
from comat_tpu_torch.training import profile
from comat_tpu_torch.training.train_step import trace_outputs

CPU = torch.device("cpu")
PROMPTS = ["a red car and a blue bird", "two green cats on a mat",
           "a yellow bus next to a brown horse", "three white cups on a table"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (pytest-xdist runs files in
    parallel processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_spans_nest_carry_their_parent_and_self_time_is_duration_less_children():
    clock = PhaseClock(CPU)
    with clock.active():
        with trace.span("step"):
            with trace.span("batch"):
                time.sleep(0.01)
            with trace.span("train_step"):
                with trace.sync("close"):
                    time.sleep(0.005)
            time.sleep(0.01)
    assert [s.name for s in clock.spans] == ["step", "batch", "train_step", "close"]
    assert [s.parent for s in clock.spans] == [-1, 0, 0, 2]
    assert [s.kind for s in clock.spans] == ["span", "span", "span", "sync"]
    assert clock.n_syncs == 1
    step, batch, train, close = clock.spans
    assert step.start_ns <= batch.start_ns < batch.end_ns <= train.start_ns
    assert train.start_ns <= close.start_ns < close.end_ns <= train.end_ns <= step.end_ns
    rows = profile.summarise([], clock.spans)["spans"]
    dur = {s.name: (s.end_ns - s.start_ns) / 1e9 for s in clock.spans}
    assert rows["step"]["self_s"] == pytest.approx(
        dur["step"] - dur["batch"] - dur["train_step"], abs=1e-9)
    assert rows["step"]["self_s"] >= 0.01
    assert rows["train_step"]["self_s"] == pytest.approx(
        dur["train_step"] - dur["close"], abs=1e-9)
    assert rows["batch"]["self_s"] == pytest.approx(dur["batch"], abs=1e-9)
    assert clock.host_seconds("batch") == pytest.approx(dur["batch"], abs=1e-9)


def test_no_active_clock_records_nothing_and_activation_is_restored():
    outer, inner = PhaseClock(CPU), PhaseClock(CPU)
    with trace.span("lost"), trace.sync("lost"):
        trace.mark("lost")
    assert trace.current() is None
    with outer.active():
        with inner.active():
            with trace.span("inner"):
                pass
        with trace.span("outer"):
            trace.mark("outer")
        assert trace.current() is outer
    with trace.span("lost"):
        pass
    assert [s.name for s in outer.spans] == ["outer"] and list(outer.marks) == ["outer"]
    assert [s.name for s in inner.spans] == ["inner"] and not inner.marks
    assert trace._active is None


def test_every_mark_has_a_host_stamp_and_leads_read_zero_on_the_cpu():
    clock = PhaseClock(CPU, probe=lambda: {"n": 1})
    before = time.time_ns()
    with clock.active():
        with trace.span("unet"):
            trace.mark("unet>")
        clock.mark("replay_op>")
    clock.close()
    after = time.time_ns()
    for entries in clock.marks.values():
        for stamp, reading, host in entries:
            assert before <= host <= after and reading == {"n": 1}
    assert sorted(clock.marks) == ["replay_op>", "unet>"]
    assert clock.leads_ms("unet>", "replay_op>") == [0.0, 0.0]
    assert clock.seconds("unet>", "replay_op>") >= 0.0 and clock.n_syncs == 1
    with pytest.raises(RuntimeError):
        PhaseClock(CPU).leads_ms("unet>")


class _ScriptedEvent:
    """A CUDA event whose device time is set by the test: `record()` takes
    the next time of `DEVICE_NS`."""

    DEVICE_NS: list = []

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = self.DEVICE_NS.pop(0)

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


def test_leads_on_a_scripted_device_clock_give_the_expected_medians(monkeypatch):
    """Host stamps and device times set by hand: the device reaches each
    mark `lead` ns after the host queued it, and the last event exactly
    when the host's wait returns, so each lead reads back exactly."""
    host = iter(range(1_000_000, 10**12, 1_000_000))      # one ms a read
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(time_ns=lambda: next(host)))
    monkeypatch.setattr(torch.cuda, "Event", _ScriptedEvent)
    clock = PhaseClock(torch.device("cuda"))
    # (mark, its lead in ms); the host reads its clock once before each
    # record, and twice around the closing wait
    plan = [("unet>", 0.004), ("unet>", 3.0), ("unet>", 9.0),
            ("replay_op>", 20.0), ("capture_op>", 1.0), ("replay_bwd>", 2.0),
            ("capture_bwd>", 40.0)]
    device, t = [], 1_000_000
    for _, lead in plan:
        device.append(t + int(lead * 1e6))
        t += 1_000_000
    device.append(t + 1_000_000)        # the last event: the anchor's read
    _ScriptedEvent.DEVICE_NS = device
    for name, _ in plan:
        clock.mark(name)
    clock.close()
    leads = clock.leads_ms(*dict.fromkeys(name for name, _ in plan))
    assert leads == pytest.approx([lead for _, lead in plan], abs=1e-9)
    out = trace_outputs(clock)
    assert out["lead_pass1_ms"] == pytest.approx(3.0)
    assert out["lead_pass2_ms"] == pytest.approx((2.0 + 20.0) / 2)
    assert out["n_syncs"] == 1.0 and out["h_batch"] == 0.0


@pytest.fixture(scope="module")
def tiny_trainer(tmp_path_factory):
    from comat_tpu_torch.training.arguments import parse_args
    from comat_tpu_torch.training.trainer import Trainer

    root = tmp_path_factory.mktemp("trace_trainer")
    (root / "p.txt").write_text("\n".join(PROMPTS))
    args = parse_args(["--training_prompts", str(root / "p.txt"), "--output_dir",
                       str(root / "out"), "--tiny_models", "--device", "cpu",
                       "--resolution", "64", "--train_batch_size", "2", "--total_step", "4",
                       "--K", "2", "--lora_rank", "4", "--gan_loss", "--report_to", "none"])
    trainer = Trainer(args)
    return trainer, root / "out"


def test_a_trainer_step_returns_its_traced_keys(tiny_trainer, monkeypatch):
    """The eight keys, finite and not negative; `n_syncs` the named sync
    sites the unsplit GAN step passed."""
    from comat_tpu_torch.training import trainer as trainer_mod

    trainer, _ = tiny_trainer
    clocks = []

    class Kept(PhaseClock):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            clocks.append(self)

    monkeypatch.setattr(trainer_mod, "PhaseClock", Kept)
    m = trainer.train_one(PROMPTS[:2])
    keys = ("h_batch", "h_segment_decode", "n_syncs", "lead_pass1_ms", "lead_pass2_ms",
            "pass1_graph_share", "n_pass1_captures", "h_step")
    for k in keys:
        assert k in m and math.isfinite(m[k]) and m[k] >= 0.0, k
    (clock,) = clocks
    syncs = [s.name for s in clock.spans if s.kind == "sync"]
    assert m["n_syncs"] == len(syncs) == clock.n_syncs
    # after the closing wait, one read a metric: the GAN recipe's six and
    # grad_norm
    assert syncs[0] == "draws.tolist"
    assert syncs[syncs.index("close"):] == ["close"] + ["metrics.read"] * 7
    assert syncs.count("clip_norm") == 2            # G's clip, then D's
    # pass 1 uploads its 4 timesteps at once; one upload a UNet call after
    # it: the replay's 2 in the backward, the GAN's G and D calls
    assert syncs.count("sampler.timesteps") == 1
    assert syncs.count("unet.timesteps") == 2 + 2
    # CPU tensors never take pass 1's CUDA graph
    assert clock.tallies == {"pass1_eager": 4}
    assert m["pass1_graph_share"] == 0.0 and m["n_pass1_captures"] == 0.0
    assert {"pipeline.ids", "blip.caption_ids", "gan.gt_latents"} <= set(syncs)
    assert m["h_step"] >= m["h_batch"] > 0.0
    names = {s.name for s in clock.spans}
    assert {"step", "batch", "draws", "train_step", "pass1", "unet", "replay", "decode",
            "losses", "backward", "optimizer", "d_update", "metrics", "finish"} <= names
    assert sum(s.name == "unet" for s in clock.spans) == 4     # --total_step 4
    assert len(clock.marks["unet>"]) == 4 and len(clock.marks["replay_op>"]) == 2


def test_sec_per_step_includes_the_batch(tiny_trainer, monkeypatch):
    trainer, out = tiny_trainer
    make = trainer._batch

    def slow(prompts):
        time.sleep(0.05)
        return make(prompts)

    monkeypatch.setattr(trainer, "_batch", slow)
    first = trainer.global_step + 1
    m = trainer.train_one(PROMPTS[2:])
    trainer._flush_pending_metrics()
    assert m["h_batch"] >= 0.05 and m["h_step"] >= 0.05
    rec = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    (logged,) = [r for r in rec if r["step"] == first]
    assert logged["sec_per_step"] >= 0.05 and logged["sec_per_step"] == m["h_step"]
    assert logged["images_per_sec"] == pytest.approx(2 / m["h_step"])
    assert logged["n_syncs"] == m["n_syncs"] and "lead_pass1_ms" in logged


def _span(name, a, b, parent=-1, kind="span"):
    return Span(name, a, b, parent, kind)


def test_summarise_puts_idle_down_to_the_innermost_span_or_outside():
    """Two steps, 0-100 and 120-200, with a child 10-40 holding a
    grandchild 20-30 in the first; kernels at 5-15, 25-60 (across the
    child's end), 95-125 (across the window's gap) and 190-230 (past the
    window's end)."""
    spans = [_span("step", 0, 100), _span("pass1", 10, 40, 0), _span("unet", 20, 30, 1),
             _span("step", 120, 200)]
    events = [(5, 15, "nvjet_tst_gemm", 4), (25, 60, "flash_fwd_bf16_kernel", 22),
              (95, 125, "void at::native::elementwise_kernel", 90),
              (190, 230, "Memcpy DtoH", 185)]
    got = profile.summarise(events, spans)
    assert got["window_s"] == pytest.approx(200e-9)
    busy = 10 + 35 + 30 + 10       # 5-15, 25-60, 95-125, 190-200
    assert got["busy_s"] == pytest.approx(busy * 1e-9)
    assert got["busy_s"] + got["idle_s"] == pytest.approx(got["window_s"])
    rows = got["spans"]
    own = {name: r["idle_own_s"] * 1e9 for name, r in rows.items()}
    # idle: 0-5 step, 15-20 pass1, 20-25 unet, 60-95 step, 125-190 step
    assert own == pytest.approx({"step": 5 + 35 + 65, "pass1": 5, "unet": 5, "outside": 0})
    assert sum(own.values()) == pytest.approx(got["idle_s"] * 1e9)
    # inside a span: kernels clipped at its edges
    assert rows["unet"]["busy_s"] * 1e9 == pytest.approx(5)
    assert rows["unet"]["device_s"] == pytest.approx({"attention": 5e-9})
    assert rows["pass1"]["device_s"] == pytest.approx({"gemm": 5e-9, "attention": 15e-9})
    assert rows["pass1"]["idle_s"] * 1e9 == pytest.approx(10)
    assert rows["outside"]["busy_s"] * 1e9 == pytest.approx(20)
    assert rows["step"]["count"] == 2
    assert rows["step"]["busy_s"] * 1e9 == pytest.approx(busy - 20)
    assert rows["step"]["kernels"] == 4 and rows["pass1"]["kernels"] == 1
    assert got["kernels"] == 4
    gaps = [(name, round(s * 1e9)) for name, s in got["gaps"]]
    assert gaps[:2] == [("step", 65), ("step", 35)]
    assert sorted(gaps[2:]) == [("pass1", 5), ("step", 5), ("unet", 5)]


# The ten longest device ops of sd15-train on an H100 80GB HBM3 (the
# benchmark's traced breakdown), as the benchmark's ledger names them
LEDGER_OPS = {
    "void_at::native::elementwise_kernel_128__4__at::native::gpu_kern": "elementwise/copy",
    "void_cudnn::engines_precompiled::nchwToNhwcKernel___nv_bfloat16_": "elementwise/copy",
    "void__anonymous_namespace_::flash_fwd_bf16_kernel_1__1__128__3__": "attention",
    "void_at::native::vectorized_elementwise_kernel_8__at::native::CU": "elementwise/copy",
    "void_at::native::_anonymous_namespace_::RowwiseMomentsCUDAKernel": "norm",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc": "conv",
    "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT": "gemm",
    "conv3x3_bf16_kernel": "conv",
    "flash_bwd_dkv_bf16_kernel": "attention",
    "Memcpy HtoD (Pageable -> Device)": "elementwise/copy",
    "void at::native::reduce_kernel<512, 1>": "other",
}


@pytest.mark.parametrize("name", sorted(LEDGER_OPS))
def test_kernel_kinds_sort_real_h100_kernel_names(name):
    assert profile.kernel_kind(name) == LEDGER_OPS[name]


def test_write_profile_writes_the_trace_with_the_spans_and_the_summary(tmp_path):
    clocks = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            clock = PhaseClock(CPU)
            with clock.active(), trace.span("step"):
                with trace.span("batch"):
                    torch.randn(64, 64) @ torch.randn(64, 64)
            clocks.append(clock)
    trace_path, summary_path = profile.write_profile(prof, clocks, str(tmp_path / "p"))
    chrome = json.loads(open(trace_path).read())
    ours = [e for e in chrome["traceEvents"] if e.get("cat") == "span"]
    assert [e["name"] for e in ours] == ["step", "batch", "step", "batch"]
    # on the trace's own clock: the spans lie among the profiler's events
    ops = [e for e in chrome["traceEvents"] if e.get("cat") == "cpu_op"]
    assert ops and min(e["ts"] for e in ours) <= min(e["ts"] for e in ops)
    assert max(e["ts"] for e in ops) <= max(e["ts"] + e["dur"] for e in ours)
    summary = json.loads(open(summary_path).read())
    assert summary["steps"] == 2 and summary["spans"]["step"]["count"] == 2
    assert summary["spans"]["batch"]["host_s"] > 0
    assert summary["busy_s"] + summary["idle_s"] == pytest.approx(summary["window_s"])
