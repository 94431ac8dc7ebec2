"""The readers of the step's traced outputs (`metrics/train.batch_s.py`,
`train.segment_decode_s`, `train.syncs`, `train.pass1_lead_ms`,
`train.pass2_lead_ms`) on fake traces: the mean over the window's steps of
the key each reads, and nothing where the program reports no such key (a
program without the step's trace)."""

import os
import types

import pytest

from benchmark import harness

READS = {"train.batch_s": "h_batch", "train.segment_decode_s": "h_segment_decode",
         "train.syncs": "n_syncs", "train.pass1_lead_ms": "lead_pass1_ms",
         "train.pass2_lead_ms": "lead_pass2_ms"}


def _reader(name):
    return harness.load_module(os.path.join(harness.HERE, "metrics", f"{name}.py"),
                               "bench_metric_test_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_is_the_mean_of_its_key_over_the_steps(name):
    key = READS[name]
    steps = [{key: 1.0, "s_step": 5.0}, {key: 2.0, "s_step": 5.0}, {key: 6.0}]
    assert _reader(name).read(types.SimpleNamespace(steps=steps)) == pytest.approx(3.0)


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_reads_nothing_where_the_program_reports_no_key(name):
    steps = [{"s_step": 5.0, "s_pass1": 3.0}, {"s_step": 5.1, "s_pass1": 3.1}]
    assert _reader(name).read(types.SimpleNamespace(steps=steps)) is None


def test_each_reader_has_its_entry():
    spec = harness.benchmark_spec()
    entries = {m["name"]: m for m in harness.per_layer_metrics(spec, "sd15-train")}
    layers = {m["layer"] for m in spec["per_layer"] if m["name"] not in READS}
    for name in READS:
        m = entries[name]
        assert m["source"] == "program_span" and m["moves"] == "images_per_s"
        assert m["workloads"] == ["sd15-train"] and m["layer"] in layers
