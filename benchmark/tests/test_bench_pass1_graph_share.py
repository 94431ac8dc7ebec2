"""The reader of pass 1's graph share (`metrics/train.pass1_graph_share.py`)
on fake traces: the mean over the window's steps of `pass1_graph_share`,
and nothing where the program reports no such key (a program without
pass 1's CUDA graph); and its entry in BENCHMARK.json."""

import os
import types

import pytest

from benchmark import harness

NAME, KEY = "train.pass1_graph_share", "pass1_graph_share"


def _reader():
    return harness.load_module(os.path.join(harness.HERE, "metrics", f"{NAME}.py"),
                               "bench_metric_test_train_pass1_graph_share")


@pytest.mark.parametrize("shares,mean", [([1.0, 1.0, 1.0], 1.0), ([0.98, 1.0], 0.99),
                                         ([0.0, 0.0], 0.0)])
def test_reader_is_the_mean_of_its_key_over_the_steps(shares, mean):
    steps = [{KEY: v, "s_step": 5.0} for v in shares] + [{"s_step": 5.0}]
    assert _reader().read(types.SimpleNamespace(steps=steps)) == pytest.approx(mean)


def test_reader_reads_nothing_where_the_program_reports_no_key():
    steps = [{"s_step": 5.0, "n_syncs": 153.0}, {"s_step": 5.1, "n_syncs": 153.0}]
    assert _reader().read(types.SimpleNamespace(steps=steps)) is None


def test_entry_reads_the_pass1_layer_in_the_trainer_cell():
    spec = harness.benchmark_spec()
    entries = {m["name"]: m for m in harness.per_layer_metrics(spec, "sd15-train")}
    m = entries[NAME]
    assert m["source"] == "program_counter" and m["moves"] == "images_per_s"
    assert m["workloads"] == ["sd15-train"]
    assert m["layer"] == entries["train.pass1_s"]["layer"]
