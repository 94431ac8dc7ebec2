"""What a benchmark run and the plain reference may load: no module whose
top-level name is jax, jaxlib, flax or comat_tpu (compared whole), and in
the reference nothing of the measured program either."""

import json
import os
import subprocess
import sys

from benchmark import harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def top_level_after(code: str):
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
                        "sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    mods = top_level_after("import benchmark.reference.step, benchmark.reference.weights, "
                           "benchmark.reference.models, benchmark.work.counts")
    assert not mods & {"comat_tpu_torch", "comat_tpu", "jax", "jaxlib", "flax"}, mods


def test_harness_and_driver_load_no_jax():
    mods = top_level_after("import benchmark.run, benchmark.harness, benchmark.inputs\n"
                           "from benchmark import harness\n"
                           "harness.load_module(harness.HERE + '/drivers/trainer.py', 'd')\n"
                           "import comat_tpu_torch.training.trainer")
    assert "comat_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN), mods


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "comat_tpu_torch_lookalike", sys)
    assert "comat_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "comat_tpu.models", sys)
    assert "comat_tpu" in harness.forbidden_modules()
