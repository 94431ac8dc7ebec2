"""Gradient accumulation in the port (`--gradient_accumulation_steps`)
against the JAX package's `optax.MultiSteps`, on the CPU.

- `ClippedAdamW` with N = 2 and 4 against JAX's `make_optimizer` (optax
  `MultiSteps(chain(clip_by_global_norm, adamw))`, the text group through
  `multi_transform`) on seeded named tensors over 2N + 1 steps: after each
  step the parameters, the running mean, the micro-step counter and
  AdamW's moments within 1e-6 of each tensor's largest magnitude (a
  relative bound; AdamW's own test holds the same). Cases: the clip
  active and not, a constant and a cosine learning-rate schedule; every
  case has a LoRA factor, a text-encoder tensor (the second group, at its
  own rate) and a bf16 tensor with its fp32 master, whose working copy
  changes only on applying steps, to the master rounded.
- The tiny trainer CLI with --gradient_accumulation_steps 2 for 4 steps
  (GAN, --tune_text_encoder): the LoRA factors move only on steps 2 and 4,
  D on every step; a run resumed from checkpoint-3 (between two updates)
  ends with the uninterrupted run's checkpoint-4 bit for bit, the running
  mean and the micro-step counter included.
- The parser no longer refuses the flag.
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from comat_tpu.training import train_step as jts
from comat_tpu.training.trainer import _lr_schedule as jlr_schedule
from comat_tpu_torch.training import arguments as targs
from comat_tpu_torch.training import train_step as tts
from comat_tpu_torch.training.trainer import lr_schedule

SHAPES = {"unet.down.attn1.to_q.lora_a": (6, 3), "unet.down.attn1.to_q.lora_b": (3, 5),
          "text.encoder.fc1.weight": (4, 7), "vae.decoder.conv.weight": (5, 4)}
BF16 = "vae.decoder.conv.weight"
PROMPTS = ["a red cube", "a blue ball", "two green cats", "a yellow bus"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per xdist worker, so that parallel test files do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= 1e-6 * scale, what


def _nested(flat):
    out = {}
    for name, v in flat.items():
        tower, rest = name.split(".", 1)
        out.setdefault(tower, {})[rest] = v
    return out


def _moments(state, key):
    """{name: array} of every AdamW moment `key` ("mu", "nu") in an optax
    state, the masked groups merged."""
    out = {}
    for _, tree in optax.tree_utils.tree_get_all_with_path(state, key):
        for tower, leaves in tree.items():
            for rest, v in leaves.items():
                if isinstance(v, jnp.ndarray):
                    out[f"{tower}.{rest}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("n,clip,schedule", [(2, "active", "constant"),
                                             (2, "inactive", "cosine"),
                                             (4, "active", "cosine"),
                                             (4, "inactive", "constant")])
def test_clipped_adamw_accumulates_as_optax_multisteps(n, clip, schedule):
    rng = np.random.default_rng(n)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    # the bf16 tensor's master holds values that bf16 does not
    grads = [{k: (rng.standard_normal(s) * (3.0 if clip == "active" else 1e-3))
              .astype(np.float32) for k, s in SHAPES.items()} for _ in range(2 * n + 1)]
    args = targs.parse_args(["--training_prompts", "p.txt", "--lr_scheduler", schedule,
                             "--lr_warmup_steps", "1", "--max_train_steps", "3",
                             "--learning_rate", "1e-2"])
    cfg = tts.TrainConfig(learning_rate=1e-2, max_grad_norm=0.5, textenc_lr=3e-2,
                          gradient_accumulation_steps=n)
    sched = lr_schedule(args)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(
        torch.bfloat16 if k == BF16 else torch.float32)) for k, v in init.items()}
    opt = tts.make_optimizer(cfg, params,
                             initial_masters={BF16: torch.from_numpy(init[BF16].copy())},
                             lr_schedule=sched)

    jcfg = jts.TrainConfig(learning_rate=1e-2, max_grad_norm=0.5, textenc_lr=3e-2,
                           gradient_accumulation_steps=n)
    jopt = jts.make_optimizer(jcfg, jlr_schedule(args))
    jparams = _nested({k: jnp.asarray(v) for k, v in init.items()})
    jstate = jopt.init(jparams)
    assert isinstance(jstate, optax.MultiStepsState)

    for i, g in enumerate(grads):
        before = params[BF16].detach().clone()
        opt.zero_grad()
        for k, v in g.items():
            opt.masters[k].grad = torch.from_numpy(v.copy())
        norm = opt.step()
        updates, jstate = jopt.update(_nested({k: jnp.asarray(v) for k, v in g.items()}),
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)

        applied = (i + 1) % n == 0
        assert opt.mini_step == int(jstate.mini_step) == (i + 1) % n
        assert opt.count == int(jstate.gradient_step) == (i + 1) // n
        _close(float(norm), np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                                        for v in g.values())), "norm")
        want = {f"{t}.{r}": np.asarray(v) for t, d in jparams.items() for r, v in d.items()}
        acc = {f"{t}.{r}": np.asarray(v) for t, d in jstate.acc_grads.items()
               for r, v in d.items()}
        for k in SHAPES:
            _close(opt.masters[k].detach().numpy(), want[k], f"step {i}: {k}")
            if acc[k].any():
                _close(opt.acc[k].numpy(), acc[k], f"step {i}: acc {k}")
            else:
                np.testing.assert_array_equal(opt.acc[k].numpy(), 0.0)
        if applied:
            for key, state_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                for k, v in _moments(jstate.inner_opt_state, key).items():
                    _close(opt.adam.state[opt.masters[k]][state_key].numpy(), v,
                           f"step {i}: {key} {k}")
            assert torch.equal(params[BF16].detach(), opt.masters[BF16].detach().to(torch.bfloat16))
        else:
            assert torch.equal(params[BF16].detach(), before)
        # the masters of the fp32 tensors are the tensors
        assert opt.masters["unet.down.attn1.to_q.lora_a"] is params[
            "unet.down.attn1.to_q.lora_a"]


def test_state_dict_round_trip_between_updates():
    """Saved after a non-applying step and loaded into a fresh optimizer,
    the next step ends as the uninterrupted one, bit for bit."""
    cfg = tts.TrainConfig(learning_rate=1e-2, gradient_accumulation_steps=3)
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]

    def make():
        params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
        return params, tts.make_optimizer(cfg, params)

    def step(opt, g):
        opt.zero_grad()
        for k, v in g.items():
            opt.masters[k].grad = torch.from_numpy(v.copy())
        opt.step()

    pa, a = make()
    for g in grads[:2]:
        step(a, g)
    saved = a.state_dict()
    assert saved["mini_step"] == 2 and set(saved["acc"]) == set(SHAPES)
    pb, b = make()
    b.load_state_dict(saved)
    for opt in (a, b):
        step(opt, grads[2])
    assert a.count == b.count == 1 and a.mini_step == b.mini_step == 0
    assert all(torch.equal(pa[k], pb[k]) for k in SHAPES)


def test_parser_takes_the_flag():
    args = targs.parse_args(["--training_prompts", "p.txt",
                             "--gradient_accumulation_steps", "8"])
    assert args.gradient_accumulation_steps == 8
    opt = tts.make_optimizer(tts.TrainConfig(gradient_accumulation_steps=8),
                             {"unet.a.lora_a": torch.nn.Parameter(torch.zeros(2))})
    assert opt.every == 8 and opt.mini_step == 0


RUN = ["--tiny_models", "--device", "cpu", "--pretrain_model_name", "sd_1_5",
       "--resolution", "64", "--train_batch_size", "2", "--total_step", "4", "--K", "2",
       "--lora_rank", "4", "--gan_loss", "--tune_text_encoder", "--textenc_lora_lr", "1e-4",
       "--seed", "3", "--gradient_accumulation_steps", "2", "--max_train_steps", "4",
       "--validation_steps", "1", "--report_to", "none"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """4 steps with a checkpoint after each, then a run resumed from
    checkpoint-3 in a directory of its own."""
    from comat_tpu_torch.train import main

    root = tmp_path_factory.mktemp("accum")
    (root / "p.txt").write_text("\n".join(PROMPTS))
    store = root / "store"
    store.mkdir()
    rng = np.random.default_rng(1)
    with open(store / "index.jsonl", "w") as f:
        for i, p in enumerate(PROMPTS):
            np.save(store / f"l{i}.npy", rng.standard_normal((8, 8, 4), np.float32))
            f.write(json.dumps({"prompt": p, "file_path": f"l{i}.npy"}) + "\n")
    run = ["--training_prompts", str(root / "p.txt"), *RUN,
           "--gan_gt_path", str(store / "index.jsonl")]
    first = root / "first"
    trainer = main(run + ["--output_dir", str(first)])
    assert trainer.state.optimizer.every == 2 and trainer.d_state.optimizer.every == 1
    resumed = root / "resumed"
    resumed.mkdir()
    shutil.copytree(first / "checkpoint-3", resumed / "checkpoint-3")
    main(run + ["--output_dir", str(resumed), "--resume_from_checkpoint", "latest"])
    return first, resumed


def _state(path):
    return torch.load(path / "state.pt", weights_only=True)


def test_trainer_updates_the_generator_every_second_step(runs):
    first, _ = runs
    states = [_state(first / f"checkpoint-{s}") for s in range(5)]

    def moved(key, a, b):
        return {n for n in a[key] if not torch.equal(a[key][n], b[key][n])}

    # the tensors the run moves at all (the tiny mid block's single key
    # gives its query and key LoRA no gradient, and their zero lora_b no
    # weight decay)
    g_all, d_all = (moved(key, states[0], states[4]) for key in ("trainable", "d_trainable"))
    assert any(n.startswith("text.") for n in g_all) and len(g_all) > 100
    assert {"head.mlp.weight", "head.mlp.bias"} <= d_all
    for s in range(1, 5):
        prev, cur = states[s - 1], states[s]
        assert cur["optimizer"]["count"] == s // 2
        assert cur["optimizer"]["mini_step"] == s % 2
        assert cur["d_optimizer"]["count"] == s
        # a micro-step moves no G tensor (weight decay neither); D moves
        # at every step
        assert moved("trainable", prev, cur) == (set() if s % 2 else g_all), s
        assert moved("d_trainable", prev, cur) == d_all, s
    recs = [json.loads(line) for line in (first / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(np.isfinite(r["grad_norm"]) and np.isfinite(r["D_loss"]) for r in recs)


def test_resume_between_updates_is_bit_for_bit(runs):
    first, resumed = runs
    mid = _state(first / "checkpoint-3")
    assert mid["optimizer"]["mini_step"] == 1 and any(
        v.abs().max() > 0 for v in mid["optimizer"]["acc"].values())
    a, b = _state(first / "checkpoint-4"), _state(resumed / "checkpoint-4")
    for key in ("trainable", "d_trainable"):
        assert a[key].keys() == b[key].keys()
        assert all(torch.equal(a[key][n], b[key][n]) for n in a[key]), key
    for key in ("optimizer", "d_optimizer"):
        assert a[key]["count"] == b[key]["count"]
        sa, sb = a[key]["adam"]["state"], b[key]["adam"]["state"]
        assert all(torch.equal(sa[i][m], sb[i][m]) for i in sa for m in sa[i])
    assert a["optimizer"]["mini_step"] == b["optimizer"]["mini_step"] == 0
    assert all(torch.equal(a["optimizer"]["acc"][n], b["optimizer"]["acc"][n])
               for n in a["optimizer"]["acc"])
    assert torch.equal(a["generator"], b["generator"])
    ra = json.loads((first / "metrics.jsonl").read_text().splitlines()[-1])
    rb = json.loads((resumed / "metrics.jsonl").read_text().splitlines()[-1])
    assert ra["step"] == rb["step"] == 4 and ra["step_loss"] == rb["step_loss"]
