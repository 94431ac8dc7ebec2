"""The trainer driver end to end at tiny geometry on the CPU, from a copy
of the benchmark to which tiny cells were added as files only
(tests/tiny.py): the result line's shape, `correct` on sound runs, and
`correct` false for each control (the reference computed in float8 in
the program's place; the program's W8A8 pass 1) and for each fault the
cell can have (a step that leaves its state unchanged; half of the batch
left out; a token altered where the host batch is made)."""

import pytest

from benchmark.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", ["tiny-train", "tinyxl-train"])
def test_added_cell_runs_and_is_correct(root, cell):
    res, mods, err = tiny.run_cell(root, cell)
    assert list(res) == KEYS
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"setup_s", "images_per_s", "peak_mem_gib"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res["checks"]) == list(tiny.limits())
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    assert mods["forbidden"] == []
    assert "comat_tpu_torch" in mods["top_level"] and "comat_tpu" not in mods["top_level"]
    assert "jax" not in mods["top_level"]
    # the numbers compared close standard error, each beside its limit
    tail = err.rstrip().splitlines()[-len(res["checks"]):]
    assert [ln.split(":")[0] for ln in tail] == [f"check {n}" for n in res["checks"]]


def test_traced_run_reports_the_per_layer_metrics(root):
    res, _, _ = tiny.run_cell(root, "tiny-train", 2147483713, 1)
    assert list(res) == KEYS[:5] + ["breakdown", "checks"]
    assert res["correct"] is True
    # the CPU has no device trace: only the program's spans and the host clock read
    assert set(res["metrics"]) == {"train.host_s", "train.pass1_s", "train.pass2_s",
                                   "train.segment_host_s", "train.losses_s",
                                   "train.optimizer_s"}
    assert res["metrics"]["train.pass1_s"]["value"] > 0


@pytest.mark.parametrize("control", ["fp8", "pass1_int8"])
def test_control_is_not_correct(root, control):
    res, _, _ = tiny.run_cell(root, "tiny-train", 2147483717, 0, "--control", control)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "token"])
def test_fault_is_not_correct(root, fault):
    res, _, _ = tiny.run_cell(root, "tiny-train", 2147483719, 0, "--fault", fault)
    assert res["correct"] is False, res["checks"]
