"""The port's trainer CLI (comat_tpu_torch/train.py, training/arguments.py,
data.py, checkpoints.py, logging_utils.py, trainer.py) against the JAX
package's, and end to end at tiny geometry on the CPU.

Against JAX: the parser's namespace on scripts/sd15.sh's flags (the port
adds only `device`); the learning-rate schedules against optax's at every
step (within 1e-6 of the peak rate: optax computes them in fp32, the port
in fp64) and `ClippedAdamW` under a schedule against optax's AdamW under
the same schedule (1e-6, as tests/test_torch_train_step.py holds the
optimizer); the prompt stream's epochs (identical); the LoRA export's
keys, orientation and values (identical, read back through
`safetensors.numpy`). End to end: `python -m comat_tpu_torch.train
--tiny_models --device cpu` with the GAN, attribute concentration and
--gradient_checkpointing runs 3 steps and writes its checkpoints, metrics
and a PNG that decodes; a run resumed from checkpoint-2, inside the first
epoch (6 prompts at batch 2), with the GAN drawing its real latents from a
latent store, ends with the uninterrupted run's trainable tensors,
optimizer state, generator state and latent store draws, bit for bit.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from comat_tpu.training import arguments as jargs
from comat_tpu.training import data as jdata
from comat_tpu.training.checkpoints import export_lora_safetensors as jexport
from comat_tpu.training.trainer import _lr_schedule as jlr_schedule
from comat_tpu_torch.training import arguments as targs
from comat_tpu_torch.training import checkpoints as tckpt
from comat_tpu_torch.training import data as tdata
from comat_tpu_torch.training import train_step as tts
from comat_tpu_torch.training.trainer import Trainer, lr_schedule

REPO = pathlib.Path(__file__).resolve().parents[1]
SD15 = REPO / "scripts" / "sd15.sh"
PORT_SD15 = REPO / "comat_tpu_torch" / "scripts" / "sd15.sh"
PROMPTS = ["a red car and a blue bird", "two green cats on a mat",
           "a yellow bus next to a brown horse", "three white cups on a table",
           "a black dog under an orange tree", "four pink flowers in a vase"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run in parallel worker processes (pytest-xdist);
    one intra-op thread per worker keeps their torch work from
    oversubscribing the cores, which slows every worker many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_parser_matches_jax_on_sd15_flags(monkeypatch):
    # the launcher's own defaults, whatever the caller's environment holds
    monkeypatch.setenv("TRAINING_PROMPTS", "mine.txt")
    argv = targs.launcher_argv(str(SD15))
    assert argv[argv.index("--training_prompts") + 1] == "collected_data/abc5k.txt"
    assert "--gradient_checkpointing" in argv and argv[argv.index("--lora_rank") + 1] == "128"
    want = vars(jargs.parse_args(argv))
    got = vars(targs.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
    # the port's launcher: the same flags (Grounded-SAM masks included),
    # then the smoke option
    assert targs.launcher_argv(str(PORT_SD15)) == argv + ["--allow_smoke"]


SURFACE_RUN = ["--tiny_models", "--device", "cpu", "--resolution", "64", "--lora_rank", "4",
               "--allow_smoke", "--report_to", "none"]


@pytest.mark.parametrize("flags", [
    ["--use_8bit_adam"], ["--full_finetuning", "--gan_loss"], ["--train_text_encoder_lora"],
    ["--pretrain_model_name", "sdxl", "--tune_text_encoder"]])
def test_ported_surface_flags_reach_the_train_config(tmp_path, flags):
    """The flags that raised until the trainable surfaces were ported
    build a trainer whose config, optimizer and trainable tensors are
    JAX's: 8-bit AdamW, the whole UNet (D on a frozen copy of its base),
    LoRA on the text towers with their gradient on, both SDXL towers."""
    from comat_tpu_torch.training.optim8bit import AdamW8bit

    trainer = Trainer(_args(tmp_path, *SURFACE_RUN, *flags))
    tcfg, trainable = trainer.tcfg, trainer.state.trainable
    towers = {n.split(".", 1)[0] for n in trainable}
    if "--use_8bit_adam" in flags:
        assert tcfg.use_8bit_adam and isinstance(trainer.state.optimizer.adam, AdamW8bit)
        assert towers == {"unet"}
    if "--full_finetuning" in flags:
        unet = trainer.pipeline.unet
        assert all(f"unet.{n}" in trainable for n, _ in unet.named_parameters())
        g_ids = {id(p) for p in unet.parameters()}
        base = [p for n, p in trainer.disc.unet.named_parameters() if "lora_" not in n]
        assert base and not any(id(p) in g_ids or p.requires_grad for p in base)
    if "--train_text_encoder_lora" in flags:
        assert trainer.pcfg.text_lora_rank == 4 and tcfg.train_text_encoder
        assert tcfg.textenc_lr == trainer.args.textenc_lora_lr
        text = [n for n in trainable if n.startswith("text.")]
        assert text and all("lora_" in n for n in text)
    if "--tune_text_encoder" in flags:
        assert trainer.pcfg.is_sdxl and tcfg.train_text_encoder
        assert towers == {"unet", "text", "text2"}
        assert "text2.text_model.final_layer_norm.weight" in trainable


SCHEDULES = [("constant", 0), ("constant", 10), ("cosine", 5), ("cosine", 0),
             ("linear", 5), ("linear", 0)]


@pytest.mark.parametrize("name,warmup", SCHEDULES)
def test_lr_schedule_matches_optax(name, warmup):
    args = targs.parse_args(["--training_prompts", "p.txt", "--lr_scheduler", name,
                             "--lr_warmup_steps", str(warmup), "--max_train_steps", "40",
                             "--learning_rate", "1e-4"])
    want = jlr_schedule(args)
    got = lr_schedule(args)
    for step in range(46):
        w = float(want(step)) if callable(want) else want
        assert abs(got(step) - w) <= 1e-6 * 1e-4, (step, got(step), w)


def test_clipped_adamw_follows_the_schedule_as_optax():
    """Four steps under linear warmup + decay, with a text group at its
    own rate (scaled by the schedule as JAX's make_optimizer scales it):
    the parameters against optax's clip + adamw(schedule) per group."""
    args = targs.parse_args(["--training_prompts", "p.txt", "--lr_scheduler", "linear",
                             "--lr_warmup_steps", "2", "--max_train_steps", "6",
                             "--learning_rate", "1e-2"])
    sched = lr_schedule(args)
    cfg = tts.TrainConfig(learning_rate=1e-2, textenc_lr=3e-3, max_grad_norm=1.0)
    rng = np.random.default_rng(0)
    shapes = {"unet.a": (5, 3), "text.b": (4,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(4)]
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = tts.make_optimizer(cfg, tensors, lr_schedule=sched)
    for g in grads:
        opt.zero_grad()
        for k, p in tensors.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    assert opt.count == 4
    clip = optax.clip_by_global_norm(1.0)
    cstate = clip.init(params)
    want = {k: jnp.asarray(v) for k, v in params.items()}
    adams = {k: optax.adamw(
        (lambda c, r=(0.3 if k.startswith("text.") else 1.0): sched(int(c)) * r),
        b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps,
        weight_decay=cfg.adam_weight_decay) for k in params}
    astates = {k: adams[k].init(want[k]) for k in params}
    for g in grads:
        clipped, cstate = clip.update({k: jnp.asarray(v) for k, v in g.items()}, cstate)
        for k in params:
            upd, astates[k] = adams[k].update(clipped[k], astates[k], want[k])
            want[k] = optax.apply_updates(want[k], upd)
    for k, p in tensors.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_prompts,batch", [(11, 4), (3, 4)])
def test_prompt_dataset_epochs_match_jax(n_prompts, batch):
    prompts = [f"prompt {i}" for i in range(n_prompts)]
    for seed in (0, 42):
        want = jdata.PromptDataset(prompts, batch, seed=seed)
        got = tdata.PromptDataset(prompts, batch, seed=seed)
        assert len(got) == len(want)
        for epoch in range(3):
            assert list(got.epoch(epoch)) == list(want.epoch(epoch))


def test_lora_export_matches_jax(tmp_path):
    """JAX's export of a tiny UNet's LoRA leaves (as `trainable` holds
    them) and the port's of the same leaves under its names."""
    import jax
    from safetensors.numpy import load_file

    from comat_tpu.config import UNetConfig
    from comat_tpu.models.unet import UNet2DCondition
    from comat_tpu_torch.weights import from_jax_params

    unet = UNet2DCondition(UNetConfig.tiny(), lora_rank=4)
    shapes = jax.eval_shape(unet.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 32)))
    rng = np.random.default_rng(2)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)

    def lora_only(path, leaf):
        return leaf if str(getattr(path[-1], "key", "")).startswith("lora_") else None

    trainable = {"unet": jax.tree_util.tree_map_with_path(lora_only, tree)}
    jexport(str(tmp_path / "jax.safetensors"), trainable)
    ours = {f"unet.{n}": t for n, t in from_jax_params({"unet": tree})["unet"].items()
            if "lora_" in n}
    tckpt.export_lora_safetensors(str(tmp_path / "port.safetensors"), ours)
    want, got = (load_file(str(tmp_path / f)) for f in ("jax.safetensors",
                                                        "port.safetensors"))
    assert len(want) == len(ours) > 0 and set(got) == set(want)
    assert all(k.endswith((".lora.down.weight", ".lora.up.weight")) for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])


def _args(tmp_path, *extra):
    (tmp_path / "p.txt").write_text("\n".join(PROMPTS))
    return targs.parse_args(["--training_prompts", str(tmp_path / "p.txt"),
                             "--output_dir", str(tmp_path / "out"), "--device", "cpu",
                             "--pretrain_model_name", "sd_1_5_attrcon", *extra])


def test_smoke_gates_raise_without_allow_smoke(tmp_path):
    with pytest.raises(RuntimeError, match="--allow_smoke"):
        Trainer(_args(tmp_path))
    (tmp_path / "snapshot" / "unet").mkdir(parents=True)
    # --seg_model gsam passes the checks made before any weights; a
    # snapshot whose unet/ folder holds no safetensors is refused there
    for seg in ("gsam", "center_prior"):
        with pytest.raises(FileNotFoundError, match="no .safetensors file in .*unet"):
            Trainer(_args(tmp_path, "--allow_smoke", "--seg_model", seg,
                          "--pretrain_model", str(tmp_path / "snapshot")))


TINY_RUN = ["--tiny_models", "--device", "cpu", "--pretrain_model_name", "sd_1_5_attrcon",
            "--resolution", "64", "--train_batch_size", "2", "--total_step", "4", "--K", "2",
            "--lora_rank", "4", "--gan_loss", "--gradient_checkpointing", "--seed", "42",
            "--max_train_steps", "3", "--validation_steps", "1",
            "--validation_prompts", "a red cube", "--num_validation_images", "1"]


def _latent_store(root):
    """Two latents a prompt, one NHWC .npy and one NCHW .pt, so that each
    draw of the GAN's real latents depends on the store's generator."""
    rng = np.random.default_rng(11)
    with open(root / "index.jsonl", "w") as f:
        for i, p in enumerate(PROMPTS):
            np.save(root / f"l{i}.npy", rng.standard_normal((8, 8, 4), np.float32))
            torch.save(torch.from_numpy(rng.standard_normal((4, 8, 8), np.float32)),
                       root / f"l{i}.pt")
            for name in (f"l{i}.npy", f"l{i}.pt"):
                f.write(json.dumps({"prompt": p, "file_path": name}) + "\n")
    return root / "index.jsonl"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted run (python -m, one torch thread) and a run
    resumed from its checkpoint-2 (`--resume_from_checkpoint latest` in a
    directory holding only that checkpoint, pruned to the newest). The 6
    prompts make 3 steps an epoch: the resumed run skips the first 2
    batches of epoch 0."""
    from comat_tpu_torch.train import main

    root = tmp_path_factory.mktemp("trainer")
    (root / "p.txt").write_text("\n".join(PROMPTS))
    store = root / "store"
    store.mkdir()
    run = [*TINY_RUN, "--gan_gt_path", str(_latent_store(store))]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    first = root / "first"
    res = subprocess.run(
        [sys.executable, "-m", "comat_tpu_torch.train", "--training_prompts",
         str(root / "p.txt"), "--output_dir", str(first), *run],
        cwd=str(root), env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    resumed = root / "resumed"
    resumed.mkdir()
    import shutil

    shutil.copytree(first / "checkpoint-2", resumed / "checkpoint-2")
    trainer = main(["--training_prompts", str(root / "p.txt"), "--output_dir",
                    str(resumed), *run, "--resume_from_checkpoint", "latest",
                    "--checkpoints_total_limit", "1"])
    assert len(trainer.dataset) == 3 and trainer.latent_store is not None
    return first, resumed


def test_cli_runs_three_steps_end_to_end(runs):
    from PIL import Image
    from safetensors.numpy import load_file

    first, _ = runs
    ckpts = sorted(p.name for p in first.glob("checkpoint-*"))
    assert ckpts == ["checkpoint-0", "checkpoint-1", "checkpoint-2", "checkpoint-3"]
    for c in ("checkpoint-0", "checkpoint-3"):
        assert json.loads((first / c / "metadata.json").read_text()) == {
            "step": int(c.split("-")[1])}
        lora = load_file(str(first / c / "pytorch_lora_weights.safetensors"))
        assert lora and all(k.startswith("unet.") and ".lora." in k for k in lora)
    recs = [json.loads(line) for line in (first / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3]
    for r in recs:
        assert all(np.isfinite(r[k]) for k in ("step_loss", "G_loss", "D_loss",
                                              "token_loss", "pixel_loss", "grad_norm"))
        assert r["lr"] == 5e-5 and r["sec_per_step"] > 0 and r["images_per_sec"] > 0
    pngs = sorted((first / "validation_images").glob("*.png"))
    assert [p.name for p in pngs] == [f"validation_0_{s}_0.png" for s in (0, 1, 2, 3)]
    img = np.asarray(Image.open(pngs[-1]))
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8


def test_resumed_run_ends_where_the_uninterrupted_run_ends(runs):
    first, resumed = runs
    assert sorted(p.name for p in resumed.glob("checkpoint-*")) == ["checkpoint-3"]
    a = torch.load(first / "checkpoint-3" / "state.pt", weights_only=True)
    b = torch.load(resumed / "checkpoint-3" / "state.pt", weights_only=True)
    for key in ("trainable", "d_trainable"):
        assert a[key].keys() == b[key].keys() and len(a[key]) > 100
        assert all(torch.equal(a[key][n], b[key][n]) for n in a[key]), key
    for key in ("optimizer", "d_optimizer"):
        assert a[key]["count"] == b[key]["count"] == 3
        sa, sb = a[key]["adam"]["state"], b[key]["adam"]["state"]
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[i][m], sb[i][m]) for i in sa for m in sa[i])
    assert torch.equal(a["generator"], b["generator"])
    # the latent store's generator: the same draws in the same order
    assert a["extra"]["latent_store_rng"] == b["extra"]["latent_store_rng"]
    mid = torch.load(first / "checkpoint-2" / "state.pt", weights_only=True)
    assert mid["extra"]["latent_store_rng"] != a["extra"]["latent_store_rng"]



def test_profile_dir_writes_a_trace_of_steps_4_to_7(tmp_path):
    from comat_tpu_torch.train import main

    (tmp_path / "p.txt").write_text("\n".join(PROMPTS))
    main(["--training_prompts", str(tmp_path / "p.txt"), "--output_dir",
          str(tmp_path / "out"), "--tiny_models", "--device", "cpu", "--resolution", "64",
          "--train_batch_size", "2", "--total_step", "4", "--K", "2", "--lora_rank", "4",
          "--max_train_steps", "8", "--profile_dir", str(tmp_path / "trace")])
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    # the program's spans of the four profiled steps, on the trace's clock
    spans = [e for e in trace["traceEvents"] if e.get("cat") in ("span", "sync")]
    assert [e["name"] for e in spans].count("step") == 4
    assert {"batch", "train_step", "pass1", "unet", "close"} <= {e["name"] for e in spans}
    summary = json.loads((tmp_path / "trace" / "profile_summary.json").read_text())
    assert summary["steps"] == 4 and summary["spans"]["step"]["count"] == 4
    assert summary["spans"]["train_step"]["host_s"] > 0
    steps = [json.loads(line)["step"]
             for line in (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    assert steps == list(range(1, 9))
