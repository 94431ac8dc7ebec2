"""The port's SDXL trainer CLI at tiny geometry on the CPU, and its SDXL
loaders against the JAX package's.

- The parser's namespace on scripts/sdxl.sh's flags equals JAX's (the port
  adds only `device`); the port's launcher comat_tpu_torch/scripts/sdxl.sh
  passes the same flags, then --allow_smoke.
- The launcher itself, run with --tiny_models --device cpu (batch 2, 64^2,
  total_step 4, K 2, LoRA 4): 2 steps with the cross-architecture D against
  a latent store, attribute concentration, --gradient_checkpointing and a
  validation image through both text towers; a run resumed from its
  checkpoint-1 ends with the uninterrupted run's checkpoint-2, bit for bit.
- `--sdxl_unet_path` on a diffusers-named UNet .safetensors the test
  writes (one proj_in as SD1.5's 1x1 conv, one tensor left out, one name
  the UNet does not hold): the port's UNet equals what JAX's
  `load_unet_params` loads, bit for bit, and the unmapped names are
  logged, not raised.
- The LoRA export of the SDXL UNet's factors: JAX's keys and values.
- `--gan_model_arch sdxl` under an SDXL generator: a same-architecture D
  sharing the generator's base, its added embedding included.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu import config as jconfig
from comat_tpu.models.hf_import import load_unet_params
from comat_tpu.models.unet import UNet2DCondition
from comat_tpu.training import arguments as jargs
from comat_tpu.training.checkpoints import export_lora_safetensors as jexport
from comat_tpu_torch.training import arguments as targs
from comat_tpu_torch.training import checkpoints as tckpt
from comat_tpu_torch.training.trainer import Trainer
from comat_tpu_torch.weights import from_jax_params

REPO = pathlib.Path(__file__).resolve().parents[1]
SDXL = REPO / "scripts" / "sdxl.sh"
PORT_SDXL = REPO / "comat_tpu_torch" / "scripts" / "sdxl.sh"
PROMPTS = ["a red car and a blue bird", "two green cats on a mat",
           "a yellow bus next to a brown horse", "three white cups on a table",
           "a black dog under an orange tree", "four pink flowers in a vase"]
# the launcher's flags, cut to tiny geometry on the CPU
TINY = ["--tiny_models", "--device", "cpu", "--resolution", "64", "--train_batch_size", "2",
        "--total_step", "4", "--K", "2", "--lora_rank", "4", "--max_train_steps", "2",
        "--validation_steps", "1", "--num_validation_images", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run in parallel worker processes (pytest-xdist);
    one intra-op thread per worker keeps their torch work from
    oversubscribing the cores, which slows every worker many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_parser_matches_jax_on_sdxl_flags(monkeypatch):
    monkeypatch.setenv("BATCH_SIZE", "2")
    argv = targs.launcher_argv(str(SDXL))
    assert argv[argv.index("--train_batch_size") + 1] == "6"
    assert argv[argv.index("--gan_model_arch") + 1] == "gansd_1_5"
    want = vars(jargs.parse_args(argv))
    got = vars(targs.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
    assert targs.launcher_argv(str(PORT_SDXL)) == argv + ["--allow_smoke"]


def _latent_store(root):
    rng = np.random.default_rng(11)
    with open(root / "index.jsonl", "w") as f:
        for i, p in enumerate(PROMPTS):
            for j in range(2):
                np.save(root / f"l{i}_{j}.npy", rng.standard_normal((8, 8, 4), np.float32))
                f.write(json.dumps({"prompt": p, "file_path": f"l{i}_{j}.npy"}) + "\n")
    return root / "index.jsonl"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The launcher run as a script (its environment names the prompts,
    output and latent store), then a run resumed from its checkpoint-1 in
    a directory holding only that checkpoint."""
    from comat_tpu_torch.train import main

    root = tmp_path_factory.mktemp("sdxl_trainer")
    (root / "p.txt").write_text("\n".join(PROMPTS))
    store = root / "store"
    store.mkdir()
    index = _latent_store(store)
    first = root / "first"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               TRAINING_PROMPTS=str(root / "p.txt"), OUTPUT_DIR=str(first),
               GAN_GT_PATH=str(index), PATH=os.path.dirname(sys.executable) + os.pathsep
               + env.get("PATH", ""))
    res = subprocess.run(["bash", str(PORT_SDXL), *TINY], cwd=str(root), env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    resumed = root / "resumed"
    resumed.mkdir()
    shutil.copytree(first / "checkpoint-1", resumed / "checkpoint-1")
    argv = targs.launcher_argv(str(PORT_SDXL))
    argv[argv.index("--training_prompts") + 1] = str(root / "p.txt")
    argv[argv.index("--gan_gt_path") + 1] = str(index)
    trainer = main([*argv, *TINY, "--output_dir", str(resumed),
                    "--resume_from_checkpoint", "latest"])
    return first, resumed, trainer


def test_launcher_runs_two_sdxl_steps(runs):
    first, _, trainer = runs
    assert trainer.pcfg.is_sdxl and trainer.disc.gan_cfg.cross_arch
    assert trainer.disc.unet.add_embedding is None and trainer.tcfg.attrcon
    assert sorted(p.name for p in first.glob("checkpoint-*")) == [
        "checkpoint-0", "checkpoint-1", "checkpoint-2"]
    recs = [json.loads(line) for line in (first / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert all(np.isfinite(r[k]) for k in ("step_loss", "G_loss", "D_loss",
                                              "token_loss", "pixel_loss", "grad_norm"))
        assert r["lr"] == 2e-5
    pngs = sorted(p.name for p in (first / "validation_images").glob("*.png"))
    assert pngs == [f"validation_0_{s}_0.png" for s in (0, 1, 2)]
    lora = tckpt.load_safetensors(str(first / "checkpoint-2"
                                      / "pytorch_lora_weights.safetensors"))
    assert lora and all(k.startswith("unet.") and ".lora." in k for k in lora)


def test_resumed_sdxl_run_ends_where_the_uninterrupted_run_ends(runs):
    first, resumed, _ = runs
    a = torch.load(first / "checkpoint-2" / "state.pt", weights_only=True)
    b = torch.load(resumed / "checkpoint-2" / "state.pt", weights_only=True)
    for key in ("trainable", "d_trainable"):
        assert a[key].keys() == b[key].keys() and len(a[key]) > 50
        assert all(torch.equal(a[key][n], b[key][n]) for n in a[key]), key
    for key in ("optimizer", "d_optimizer"):
        assert a[key]["count"] == b[key]["count"] == 2
        sa, sb = a[key]["adam"]["state"], b[key]["adam"]["state"]
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[i][m], sb[i][m]) for i in sa for m in sa[i])
    assert torch.equal(a["generator"], b["generator"])
    assert a["extra"] == b["extra"]


def _jax_unet_tree(rank=4, seed=2):
    """A tiny SDXL UNet's JAX tree, filled from numpy."""
    unet = UNet2DCondition(jconfig.UNetConfig.tiny_xl(cross_attention_dim=64),
                           lora_rank=rank)
    added = {"text_embeds": jnp.zeros((1, 32)), "time_ids": jnp.zeros((1, 6))}
    shapes = jax.eval_shape(unet.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64)), added)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def test_sdxl_unet_path_loads_as_jax_and_logs_unmapped_names(tmp_path):
    port_names = from_jax_params({"unet": _jax_unet_tree(seed=5)})["unet"]
    diffusers = {}
    for name, t in port_names.items():
        if "lora_" in name or name == "conv_in.bias":       # left out: unmapped
            continue
        name = name.replace(".base.", ".")
        arr = t.numpy()
        if name == "up_blocks.0.attentions.1.proj_in.weight":
            arr = arr[:, :, None, None]                     # SD1.5's 1x1 conv layout
        diffusers[name] = arr
    assert "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_out.0.weight" in diffusers
    assert "add_embedding.linear_1.weight" in diffusers
    diffusers["extra.weight"] = np.ones((3,), np.float32)  # not the UNet's
    path = tmp_path / "unet.safetensors"
    tckpt.save_safetensors(str(path), diffusers)

    jax_tree = _jax_unet_tree(seed=7)
    loaded, missing = load_unet_params(str(path), jax_tree)
    assert missing == ["conv_in/bias -> conv_in.bias"]
    want = from_jax_params({"unet": jax.tree_util.tree_map(np.asarray, loaded)})["unet"]

    (tmp_path / "p.txt").write_text("\n".join(PROMPTS))
    out = tmp_path / "out"
    trainer = Trainer(targs.parse_args([
        "--training_prompts", str(tmp_path / "p.txt"), "--output_dir", str(out),
        "--device", "cpu", "--tiny_models", "--pretrain_model_name", "sdxl",
        "--resolution", "64", "--lora_rank", "4", "--sdxl_unet_path", str(path)]))
    got = trainer.pipeline.unet.state_dict()
    assert set(got) == set(want)
    for name, t in got.items():
        if "lora_" in name or name == "conv_in.bias":
            continue
        assert torch.equal(t, want[name]), name
    log = (out / "log.txt").read_text()
    assert "sdxl_unet_path: 1 unmapped params (first: ['conv_in.bias']), 1 unused " \
           "tensors (first: ['extra.weight'])" in log


def test_sdxl_lora_export_matches_jax(tmp_path):
    tree = _jax_unet_tree()

    def lora_only(path, leaf):
        return leaf if str(getattr(path[-1], "key", "")).startswith("lora_") else None

    jexport(str(tmp_path / "jax.safetensors"),
            {"unet": jax.tree_util.tree_map_with_path(lora_only, tree)})
    ours = {f"unet.{n}": t for n, t in from_jax_params({"unet": tree})["unet"].items()
            if "lora_" in n}
    tckpt.export_lora_safetensors(str(tmp_path / "port.safetensors"), ours)
    want, got = (tckpt.load_safetensors(str(tmp_path / f))
                 for f in ("jax.safetensors", "port.safetensors"))
    assert len(want) == len(ours) > 0 and set(got) == set(want)
    assert any(".attentions.1.transformer_blocks.1.attn2." in k for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_same_arch_sdxl_d_shares_the_generator_base(tmp_path):
    from comat_tpu_torch.train import main

    (tmp_path / "p.txt").write_text("\n".join(PROMPTS))
    trainer = main(["--training_prompts", str(tmp_path / "p.txt"), "--output_dir",
                    str(tmp_path / "out"), "--tiny_models", "--device", "cpu",
                    "--pretrain_model_name", "sdxl", "--resolution", "64",
                    "--train_batch_size", "2", "--total_step", "4", "--K", "2",
                    "--lora_rank", "4", "--gan_loss", "--gan_model_arch", "sdxl",
                    "--max_train_steps", "1"])
    disc, unet = trainer.disc, trainer.pipeline.unet
    assert not disc.gan_cfg.cross_arch
    assert disc.unet.add_embedding.linear_1.weight is unet.add_embedding.linear_1.weight
    rec = json.loads((tmp_path / "out" / "metrics.jsonl").read_text())
    assert np.isfinite(rec["D_loss"]) and np.isfinite(rec["G_loss"])


def test_generate_tool_runs_sdxl(tmp_path):
    from comat_tpu_torch.tools.generate import main

    images, _ = main(["--model", "sdxl", "--tiny", "--device", "cpu", "--resolution", "64",
                      "--num-inference-steps", "2", "--out-dir", str(tmp_path),
                      "--prompt", "a red cube", "a blue sphere"])
    assert images.shape == (2, 64, 64, 3) and torch.isfinite(images).all()
    assert sorted(p.name for p in tmp_path.glob("*.png")) == ["000.png", "001.png"]
