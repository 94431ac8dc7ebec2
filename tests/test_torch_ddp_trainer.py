"""The port's trainer over a process group, at tiny geometry on the CPU.

Two processes of `python -m comat_tpu_torch.train --tiny_models --device
cpu`, each given the environment `torchrun` gives its rank (RANK,
LOCAL_RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), train SD1.5 with the
GAN for 2 steps at --train_batch_size 2 with a checkpoint at every step:

- rank 0 alone writes the checkpoints, metrics.jsonl, log.txt and the
  LoRA export, which both ranks share an output folder for;
- each step's metrics equal one process's at --train_batch_size 4 within
  1e-5 relative, and the LoRA after each step within 1e-4 relative (each
  tensor's max |delta| over its max |value|; the worst measured here is
  2.8e-5, LoRA B of the first cross-attention: the two runs' CPU kernels
  sum over batches of 2 and of 4 in different orders, and the guided
  sampling amplifies the difference before the gradient reads it). The
  latent store holds one latent a prompt: each process chooses among a
  prompt's latents with its own seed-0 generator, as JAX's processes do,
  so with several a prompt one process and two choose differently.
  AdamW's epsilon is 1 in these runs, so that an update is the clipped
  gradient times the rate and the LoRA compares the gradients: LoRA B
  starts at zero, and at the default 1e-8 its first update
  lr g / (|g| + eps) is lr sign(g), which the last bit of a gradient near
  zero flips;
- a run resumed from checkpoint-1 at world 2, with a store of two latents
  a prompt (the ranks' store generators then matter), ends with the
  uninterrupted run's checkpoint-2 bit for bit.

Then, in spawned processes holding a Gloo group (`train.main` keeps a
caller's group): --mesh_model_axis 2 at world 2 makes two replicas that
see the same prompts and train as one process at the same batch, and
--mesh_model_axis 3 at world 2 raises.
"""

import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from comat_tpu_torch import trace
from comat_tpu_torch.training import checkpoints as tckpt
from torch_dist import free_port, run_ranks, tiny_env

REPO = pathlib.Path(__file__).resolve().parents[1]
PROMPTS = ["a red car and a blue bird", "two green cats on a mat",
           "a yellow bus next to a brown horse", "three white cups on a table",
           "a black dog under an orange tree", "four pink flowers in a vase",
           "a small boat", "five grey stones on the sand"]
RUN = ["--tiny_models", "--device", "cpu", "--pretrain_model_name", "sd_1_5",
       "--resolution", "64", "--total_step", "4", "--K", "2", "--lora_rank", "4",
       "--gan_loss", "--max_train_steps", "2", "--validation_steps", "1",
       "--num_validation_images", "0", "--report_to", "none", "--seed", "3",
       "--adam_epsilon", "1"]
REL, LORA_REL = 1e-5, 1e-4


def _store(root, per_prompt):
    rng = np.random.default_rng(11)
    root.mkdir()
    with open(root / "index.jsonl", "w") as f:
        for i, p in enumerate(PROMPTS):
            for j in range(per_prompt):
                np.save(root / f"l{i}_{j}.npy", rng.standard_normal((8, 8, 4), np.float32))
                f.write(json.dumps({"prompt": p, "file_path": f"l{i}_{j}.npy"}) + "\n")
    return root / "index.jsonl"


def _cli(root, out, world, batch, store, *extra):
    """The trainer CLI in `world` processes (one without a process group
    when world is 1); returns each process's output."""
    argv = [sys.executable, "-m", "comat_tpu_torch.train", *RUN,
            "--training_prompts", str(root / "p.txt"), "--output_dir", str(out),
            "--train_batch_size", str(batch), "--gan_gt_path", str(store), *extra]
    port = free_port()
    procs = []
    for rank in range(world):
        env = tiny_env(rank, world, port, PYTHONPATH=str(REPO))
        if world == 1:
            for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
                env.pop(k)
        procs.append(subprocess.Popen(argv, cwd=str(root), env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = [p.communicate(timeout=900)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_trainer")
    (root / "p.txt").write_text("\n".join(PROMPTS))
    one, two = _store(root / "store1", 1), _store(root / "store2", 2)
    logs = _cli(root, root / "w2", 2, 2, one)
    _cli(root, root / "w1", 1, 4, one)
    _cli(root, root / "w2s", 2, 2, two)
    (root / "resumed").mkdir()
    shutil.copytree(root / "w2s" / "checkpoint-1", root / "resumed" / "checkpoint-1")
    _cli(root, root / "resumed", 2, 2, two, "--resume_from_checkpoint", "latest")
    return root, logs


def _records(out):
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def test_rank0_alone_writes(runs):
    root, logs = runs
    out = root / "w2"
    assert sorted(p.name for p in out.glob("checkpoint-*")) == [
        "checkpoint-0", "checkpoint-1", "checkpoint-2"]
    assert [r["step"] for r in _records(out)] == [1, 2]     # one writer
    assert "saved checkpoint" in logs[0] and "saved checkpoint" not in logs[1]
    assert "[rank 1]" in logs[1]
    text = (out / "log.txt").read_text()
    assert "[rank 0]" in text and "[rank 1]" not in text
    assert (out / "checkpoint-2" / "pytorch_lora_weights.safetensors").is_file()
    state = torch.load(out / "checkpoint-2" / "state.pt", weights_only=True)
    assert len(state["extra"]["latent_store_rngs"]) == 2


def test_world2_equals_world1_at_twice_the_batch(runs):
    root, _ = runs
    w2, w1 = _records(root / "w2"), _records(root / "w1")
    for a, b in zip(w2, w1):
        for key in ("step_loss", "reward_blip", "G_loss", "D_loss", "reward_norm",
                    "grad_norm"):
            assert abs(a[key] - b[key]) <= REL * abs(b[key]), (key, a[key], b[key])
        assert a["allreduce_bytes"] > 0 and "allreduce_bytes" not in b
    for step in (1, 2):
        lora2, lora1 = (tckpt.load_safetensors(str(
            root / run / f"checkpoint-{step}" / "pytorch_lora_weights.safetensors"))
            for run in ("w2", "w1"))
        assert set(lora2) == set(lora1) and lora1
        for n, want in lora1.items():
            got = np.asarray(lora2[n], np.float64)
            want = np.asarray(want, np.float64)
            assert np.abs(got - want).max() <= LORA_REL * np.abs(want).max(), (step, n)


def test_world2_resume_is_bit_for_bit(runs):
    root, _ = runs
    a = torch.load(root / "w2s" / "checkpoint-2" / "state.pt", weights_only=True)
    b = torch.load(root / "resumed" / "checkpoint-2" / "state.pt", weights_only=True)
    for key in ("trainable", "d_trainable"):
        assert a[key].keys() == b[key].keys()
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), (key, n)
    assert torch.equal(a["generator"], b["generator"])
    assert a["extra"]["latent_store_rngs"] == b["extra"]["latent_store_rngs"]
    for key in ("optimizer", "d_optimizer"):
        sa, sb = a[key]["adam"]["state"], b[key]["adam"]["state"]
        for i in sa:
            for k in sa[i]:
                assert torch.equal(sa[i][k], sb[i][k]), (key, i, k)


def _main_rank(rank, world, argv):
    from comat_tpu_torch.train import main

    trainer = main(argv)
    first = next(iter(trainer.dataset.epoch(0)))
    lora = {n: m.detach().numpy().copy() for n, m in trainer.state.optimizer.masters.items()}
    return first, trainer.mesh.data, trainer.mesh.model, lora


def test_model_axis_two_makes_replicas(tmp_path):
    (tmp_path / "p.txt").write_text("\n".join(PROMPTS))
    argv = [*RUN, "--training_prompts", str(tmp_path / "p.txt"), "--train_batch_size", "2",
            "--validation_steps", "0", "--gan_loss"]
    out = run_ranks(_main_rank, 2, [*argv, "--output_dir", str(tmp_path / "m2"),
                                    "--mesh_model_axis", "2"])
    ref = run_ranks(_main_rank, 1, [*argv, "--output_dir", str(tmp_path / "m1")])[0]
    (p0, d0, m0, l0), (p1, d1, m1, l1) = out
    assert (d0, m0) == (1, 2) and p0 == p1 == ref[0]      # both replicas on the same rows
    r0, r1 = _records(tmp_path / "m2"), _records(tmp_path / "m1")
    assert [r["step_loss"] for r in r0] == pytest.approx([r["step_loss"] for r in r1],
                                                          rel=REL)
    for n, want in ref[3].items():
        np.testing.assert_array_equal(l0[n], l1[n])
        assert np.abs(l0[n] - want).max() <= LORA_REL * np.abs(want).max(), n


def test_model_axis_that_does_not_divide_the_world_raises(tmp_path):
    (tmp_path / "p.txt").write_text("\n".join(PROMPTS))
    argv = [*RUN, "--training_prompts", str(tmp_path / "p.txt"), "--train_batch_size", "2",
            "--output_dir", str(tmp_path / "m3"), "--mesh_model_axis", "3"]
    with pytest.raises(RuntimeError, match=r"a \(0, 3\) mesh needs 0 ranks, the world has 2"):
        run_ranks(_main_rank, 2, argv)


class BandSegmenter:
    """An image-dependent stand-in for Grounded-SAM (the trainer then takes
    the split step): per noun a top band whose height follows the image's
    mean red, within [H/4, H/2]. Counts its batch calls."""

    image_dependent = True

    def __init__(self):
        self.calls = 0

    def __call__(self, image01, nouns):
        H, W, _ = image01.shape
        r = int(np.clip(round(H * float(image01[..., 0].mean())), H // 4, H // 2))
        m = np.zeros((H, W), np.float32)
        m[:r] = 1.0
        return [m for _ in nouns]

    def batch(self, images01, nouns_list):
        self.calls += 1
        trace.mark("segment_device")
        return [self(img, nouns) for img, nouns in zip(images01, nouns_list)]


def _split_rank(rank, world, argv):
    from comat_tpu_torch.segmentation import interface
    from comat_tpu_torch.train import main

    stub = BandSegmenter()
    # --tiny_models builds the center prior: the stand-in takes its place
    interface.CenterPriorSegmenter = lambda: stub
    trainer = main(argv)
    assert trainer.presample is not None and trainer.seg_holder.segmenter is stub
    return stub.calls, trainer.mesh.model_index


@pytest.mark.parametrize("model_axis", [1, 2])
def test_split_step_segments_once_a_model_group(tmp_path, model_axis):
    """With an image-dependent segmenter each data group's first rank
    segments its rows; at --mesh_model_axis 2 the replica takes its masks
    and trains as it does (the same losses as one process)."""
    (tmp_path / "p.txt").write_text("\n".join(PROMPTS))
    argv = ["--tiny_models", "--device", "cpu", "--pretrain_model_name", "sd_1_5_attrcon",
            "--resolution", "64", "--total_step", "4", "--K", "2", "--lora_rank", "4",
            "--attrcon_train_steps", "1", "--max_train_steps", "2", "--validation_steps", "0",
            "--report_to", "none", "--training_prompts", str(tmp_path / "p.txt"),
            "--train_batch_size", "2", "--mesh_model_axis", str(model_axis)]
    out = run_ranks(_split_rank, 2, [*argv, "--output_dir", str(tmp_path / "w2")])
    # (batch calls, model index) by rank: two steps, one call a step
    assert out == ([(2, 0), (0, 1)] if model_axis == 2 else [(2, 0), (2, 0)])
    records = _records(tmp_path / "w2")
    assert [r["step"] for r in records] == [1, 2]
    assert all(r["token_loss"] > 0 and r["s_segment"] > 0 for r in records)
    if model_axis == 2:
        run_ranks(_split_rank, 1, [*argv[:-2], "--output_dir", str(tmp_path / "w1")])
        ref = _records(tmp_path / "w1")
        assert [r["step_loss"] for r in records] == pytest.approx(
            [r["step_loss"] for r in ref], rel=REL)
