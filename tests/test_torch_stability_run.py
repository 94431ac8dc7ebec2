"""The port's stability tool (comat_tpu_torch/tools/stability_run.py) at
the tiny geometry on the CPU: N steps of bench's default step, a line a
step with its seconds, loss and reward, the steady-state line, every loss
finite; it imports no JAX (it builds through the port, not bench.py); a
run of fewer than 3 steps is refused (the steady state starts at step 2)."""

import math
import os
import pathlib
import subprocess
import sys

import pytest

from comat_tpu_torch.tools import stability_run

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_tiny_run_prints_a_line_a_step(capsys):
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec = stability_run.main(["--steps", "3", "--batch-size", "2", "--device", "cpu",
                                  "--tiny"])
    finally:
        torch.set_num_threads(threads)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == ["step 0", "step 1", "step 2"]
    assert lines[3].startswith("steady-state: ") and lines[3].endswith("all finite: True")
    assert len(rec["seconds"]) == len(rec["losses"]) == len(rec["rewards"]) == 3
    assert rec["all_finite"] and all(math.isfinite(x) for x in rec["rewards"])
    assert rec["steady_s"] == rec["seconds"][2] and rec["device"] == "cpu"
    assert rec["images_per_s"] == pytest.approx(2 / rec["steady_s"])


def test_builds_without_jax_and_refuses_short_runs():
    with pytest.raises(ValueError, match="at least 3"):
        stability_run.main(["--steps", "2", "--device", "cpu", "--tiny"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    code = ("import sys; from comat_tpu_torch.tools import stability_run as s; "
            "s.build(1, 'cpu', tiny=True); "
            "print(any(m == 'jax' or m.startswith(('jax.', 'comat_tpu.')) for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
