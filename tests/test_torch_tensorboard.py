"""The trainer's TensorBoard log (`--report_to`, `--logging_dir`), as JAX's
`MetricsWriter` writes it, on the CPU at tiny geometry.

- A 3-step CLI run with the launchers' default (--report_to tensorboard,
  --logging_dir logs) writes an events file under `<output_dir>/logs`
  whose scalar tags are exactly metrics.jsonl's metric keys, each with a
  value a step equal to the jsonl's, and the validation images.
- With `torch.utils.tensorboard` unimportable (as where no tensorboard
  package is installed) the run goes on: log.txt holds one warning naming
  the reason, and metrics.jsonl is written.
- --report_to none writes no events file.
"""

import json
import sys

import numpy as np
import pytest
import torch

from comat_tpu_torch.train import main

RUN = ["--tiny_models", "--device", "cpu", "--pretrain_model_name", "sd_1_5",
       "--resolution", "64", "--train_batch_size", "2", "--total_step", "4", "--K", "2",
       "--lora_rank", "4", "--max_train_steps", "3", "--validation_steps", "2",
       "--validation_prompts", "a red cube", "--num_validation_images", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per xdist worker, so that parallel test files do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(tmp_path, *extra):
    (tmp_path / "p.txt").write_text("a red cube\na blue ball\ntwo green cats\n")
    out = tmp_path / "out"
    main(["--training_prompts", str(tmp_path / "p.txt"), "--output_dir", str(out), *RUN,
          *extra])
    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3]
    return out, recs


def test_events_hold_the_metrics_jsonl_keys(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    out, recs = _run(tmp_path)
    events = list((out / "logs").glob("events.out.tfevents.*"))
    assert len(events) == 1
    acc = EventAccumulator(str(out / "logs"), size_guidance={"images": 0})
    acc.Reload()
    keys = set(recs[0]) - {"step", "time"}
    assert set(acc.Tags()["scalars"]) == keys and "step_loss" in keys
    for k in keys:
        got = [(e.step, e.value) for e in acc.Scalars(k)]
        want = [(r["step"], r[k]) for r in recs]
        assert [s for s, _ in got] == [s for s, _ in want], k
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                                   rtol=1e-6, err_msg=k)
    # the validation images at steps 0, 2 and the end
    assert acc.Tags()["images"] == ["validation_0"]
    assert [e.step for e in acc.Images("validation_0")] == [0, 2, 3]


def test_without_tensorboard_the_log_says_why_and_jsonl_stays(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    out, recs = _run(tmp_path)
    log = (out / "log.txt").read_text()
    warnings = [line for line in log.splitlines() if "no TensorBoard log" in line]
    assert len(warnings) == 1 and "torch.utils.tensorboard" in warnings[0], warnings
    assert not (out / "logs").exists()
    assert all(np.isfinite(r["step_loss"]) for r in recs)


def test_report_to_none_writes_no_events(tmp_path):
    out, _ = _run(tmp_path, "--report_to", "none")
    assert not (out / "logs").exists()
    assert "no TensorBoard log" not in (out / "log.txt").read_text()
