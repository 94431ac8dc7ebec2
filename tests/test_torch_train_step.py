"""The port's train step (comat_tpu_torch/training/train_step.py) against
the JAX one, at tiny geometry in fp32 on the CPU.

One JAX run, shared by the tests through a module-scoped fixture:
`jax.value_and_grad(make_loss_fn(...))` with `disc=None` and attrcon off,
LoRA rank 4 with nonzero `lora_b`, 64^2, total_step 10, K 5, batch 2,
BLIP tiny. The injected draws (initial latents, per-step noise, K-schedule
start, crop offsets) come from the same `jax.random` calls the JAX step
makes, as `tools/step_loss_fixture.run_fixture` replicates them.

Tolerances, those of the JAX package's own whole-step gates
(`tools/step_loss_fixture.py`): the loss within 1e-3 absolute, each LoRA
gradient leaf within 1e-3 relative (max |delta| over max |grad|); the
final latents within 1e-3 absolute (ten UNet passes accumulate the
1e-4-level per-module differences of test_torch_modules.py, scaled by the
CFG scale of 7.5). The optimizer is held to optax on the same gradients
within 1e-6 relative: the same fp32 update in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from comat_tpu.config import BLIPConfig as JBLIPConfig
from comat_tpu.losses.caption_reward import build_caption_batch
from comat_tpu.models import pipeline as jpipe
from comat_tpu.models.blip import BLIPCaptioner as JBLIP
from comat_tpu.text.tokenizer import HashTokenizer
from comat_tpu.training import train_step as jts
from comat_tpu_torch.config import BLIPConfig
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.models.blip import BLIPCaptioner
from comat_tpu_torch.training import train_step as tts
from comat_tpu_torch.weights import from_jax_params

PROMPTS = ["a red car and a blue bird", "two green cats on a mat"]
RES, STEPS, K, RANK = 64, 10, 5, 4
LOSS_TOL, GRAD_TOL = 1e-3, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run in parallel worker processes (pytest-xdist);
    one intra-op thread per worker keeps their torch work from
    oversubscribing the cores, which slows every worker many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nonzero_lora_b(params, seed=3):
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        if getattr(path[-1], "key", None) == "lora_b":
            return jnp.asarray(0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(f, params)


def _nested(flat):
    """{(k1, k2, ...): leaf} -> nested dicts."""
    out = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _lora_grads_by_port_name(grads):
    """The JAX LoRA gradient leaves under the port's parameter names."""
    flat = {
        tuple(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]
    }
    unet = _nested({p[1:]: v for p, v in flat.items() if p[0] == "unet"})
    return from_jax_params({"unet": unet})["unet"]


@pytest.fixture(scope="module")
def case():
    jax.config.update("jax_default_matmul_precision", "highest")
    pcfg = jpipe.make_pipeline_config("sd_1_5", lora_rank=RANK, resolution=RES,
                                      tiny=True)
    pipe = jpipe.DiffusionPipeline(pcfg)
    params = _nonzero_lora_b(pipe.init_params(jax.random.PRNGKey(0)))
    tok = HashTokenizer(1000)
    enc = tok(PROMPTS, max_length=77)
    null = tok([""] * len(PROMPTS), max_length=77)
    cap = build_caption_batch(tok, PROMPTS)
    batch = {
        "input_ids": enc["input_ids"], "eos_positions": enc["eos_positions"],
        "null_ids": null["input_ids"], "caption_ids": cap["input_ids"],
        "caption_mask": cap["attention_mask"], "caption_labels": cap["labels"],
    }
    blip = JBLIP(JBLIPConfig.tiny())
    blip_params = blip.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)),
        jnp.asarray(cap["input_ids"][:1]), jnp.asarray(cap["attention_mask"][:1]),
        jnp.asarray(cap["labels"][:1]),
    )
    jcfg = jts.TrainConfig(total_step=STEPS, K=K, resolution=RES)

    # the draws of the JAX step at state.step == 0 (train_step.loss_fn and
    # pipeline.forward), replicated as step_loss_fixture does
    rng0 = jax.random.fold_in(jax.random.PRNGKey(5), 0)
    rngs = jax.random.split(rng0, 4)
    trained_idx = np.asarray(jts.sample_trained_idx(rngs[0], jcfg))
    rng_noise, lrng = jax.random.split(rngs[1])
    h = RES // 8
    latents0 = np.asarray(jax.random.normal(lrng, (len(PROMPTS), h, h, 4)))
    noise = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(rng_noise, i),
                                     (len(PROMPTS), h, h, 4)))
        for i in range(STEPS)
    ])
    offset_range = RES // 224
    crop = tuple(int(jax.random.randint(r, (), 0, offset_range + 1))
                 for r in rngs[2:])

    trainable, frozen = jts.partition_params(params)
    loss_fn = jts.make_loss_fn(pipe, blip, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, (metrics, latents)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True)
    )(trainable, frozen, blip_params, jbatch, rng0, None)

    weights = from_jax_params(jax.tree_util.tree_map(
        np.asarray, {**params, "blip": blip_params}))
    draws = tts.StepDraws(torch.tensor(latents0), torch.tensor(noise),
                          int(trained_idx[0]), crop)
    return dict(
        batch=batch, weights=weights, draws=draws, jcfg=jcfg,
        loss=float(loss), metrics={k: float(v) for k, v in metrics.items()},
        latents=np.asarray(latents), grads=_lora_grads_by_port_name(grads),
        grad_norm=float(optax.global_norm(grads)),
    )


def _port(case):
    cfg = tpipe.make_pipeline_config("sd_1_5", lora_rank=RANK, resolution=RES,
                                     tiny=True)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu", params=case["weights"])
    blip = BLIPCaptioner(BLIPConfig.tiny()).requires_grad_(False)
    blip.load_state_dict(case["weights"]["blip"])
    tcfg = tts.TrainConfig(**{f.name: getattr(case["jcfg"], f.name)
                              for f in dataclasses.fields(tts.TrainConfig)})
    return pipe, blip, tcfg


@pytest.fixture(scope="module")
def port_loss(case):
    pipe, blip, tcfg = _port(case)
    trainable = tts.partition_params(pipe)
    loss, (metrics, latents) = tts.make_loss_fn(pipe, blip, tcfg)(
        case["batch"], case["draws"])
    loss.backward()
    grads = {n[len("unet."):]: p.grad.clone() for n, p in trainable.items()}
    return float(loss.detach()), {k: float(v) for k, v in metrics.items()}, latents, grads


def test_forward_latents_match_jax(case, port_loss):
    latents = port_loss[2]
    assert latents.shape == case["latents"].shape and latents.requires_grad
    np.testing.assert_allclose(latents.detach().numpy(), case["latents"],
                               atol=1e-3, rtol=0)


@pytest.mark.parametrize("key", ["step_loss", "reward_blip", "reward_total",
                                 "reward_norm"])
def test_loss_and_metrics_match_jax(case, port_loss, key):
    loss, metrics, _, _ = port_loss
    assert abs(loss - case["loss"]) <= LOSS_TOL
    assert abs(metrics[key] - case["metrics"][key]) <= LOSS_TOL * max(
        1.0, abs(case["metrics"][key]))


def test_lora_gradients_match_jax(case, port_loss):
    grads, want = port_loss[3], case["grads"]
    assert set(grads) == set(want) and len(want) > 0
    assert all(n.endswith(("lora_a", "lora_b")) for n in want)
    worst = 0.0
    for name, w in want.items():
        g = grads[name].numpy().astype(np.float64)
        w = w.numpy().astype(np.float64)
        denom = max(np.abs(g).max(), np.abs(w).max(), 1e-12)
        worst = max(worst, np.abs(g - w).max() / denom)
    assert worst <= GRAD_TOL, worst
    # the lora_a gradients are not zero: lora_b was made nonzero
    assert max(float(g.abs().max()) for n, g in grads.items()
               if n.endswith("lora_a")) > 0


def _optax_update(cfg, params, grads, steps=1):
    opt = optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adamw(cfg.learning_rate, b1=cfg.adam_b1, b2=cfg.adam_b2,
                    eps=cfg.adam_eps, weight_decay=cfg.adam_weight_decay),
    )
    params = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(params)
    for g in grads[:steps]:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in params.items()}


def test_train_step_update_matches_optax(case, port_loss):
    """One make_train_step update of the LoRA leaves: the port's own
    gradients (those of port_loss; the CPU run repeats them) through
    optax's clip_by_global_norm(0.1) + adamw give the same new leaves."""
    pipe, blip, tcfg = _port(case)
    state = tts.init_train_state(pipe, tcfg)
    before = {n[len("unet."):]: p.detach().clone().numpy()
              for n, p in state.trainable.items()}
    state, metrics = tts.make_train_step(pipe, blip, tcfg)(
        state, case["batch"], case["draws"])
    assert state.step == 1
    assert metrics["grad_norm"] > tcfg.max_grad_norm      # the clip acts
    assert abs(metrics["grad_norm"] - case["grad_norm"]) <= GRAD_TOL * case["grad_norm"]
    grads = {n: g.numpy() for n, g in port_loss[3].items()}
    want = _optax_update(tcfg, before, [grads])
    for n, p in state.trainable.items():
        got = p.detach().numpy()
        assert not np.array_equal(got, before[n[len("unet."):]])
        np.testing.assert_allclose(got, want[n[len("unet."):]], rtol=1e-6, atol=1e-9)
    assert set(metrics) >= {"reward_blip", "reward_total", "reward_norm",
                            "step_loss", "grad_norm", "s_step"}


@pytest.mark.parametrize("scale", [0.01, 10.0])
@pytest.mark.parametrize("textenc_lr", [None, 1e-3])
def test_clipped_adamw_matches_optax(scale, textenc_lr):
    """Three steps on given gradients, under and over the clip norm; with
    `textenc_lr` the text tensors move at their own rate (optax's
    multi_transform), the clip staying joint."""
    rng = np.random.default_rng(0)
    shapes = {"unet.a": (8, 4), "unet.b": (4, 3), "text.c": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    cfg = tts.TrainConfig(learning_rate=1e-2, textenc_lr=textenc_lr)
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = tts.make_optimizer(cfg, tensors)
    for g in grads:
        opt.zero_grad()
        for k, p in tensors.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    if textenc_lr is None:
        want = _optax_update(cfg, params, grads, steps=3)
    else:
        main = _optax_update(cfg, params, grads, steps=3)
        text = _optax_update(dataclasses.replace(cfg, learning_rate=textenc_lr),
                             params, grads, steps=3)
        want = {k: (text if k.startswith("text.") else main)[k] for k in params}
    for k, p in tensors.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-6, atol=1e-7)


def test_unported_flags_raise():
    """No flag of the step is left unported: the GAN, attribute
    concentration, remat, gradient accumulation, 8-bit Adam and the int8
    pass 1 build the optimizer (--mesh_model_axis, the parser's last
    refusal, is ported too: tests/test_torch_ddp_trainer.py)."""
    tts.make_optimizer(tts.TrainConfig(gan_loss=True, attrcon=True,
                                       gradient_checkpointing=True, remat_min_res=64,
                                       gradient_accumulation_steps=2, use_8bit_adam=True,
                                       pass1_int8=True),
                       {"unet.a": torch.nn.Parameter(torch.zeros(2))})


def test_partition_params_marks_the_trainable_tensors():
    cfg = tpipe.make_pipeline_config("sd_1_5", lora_rank=RANK, resolution=RES,
                                     tiny=True)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu")
    lora = tts.partition_params(pipe)
    assert lora and all(n.startswith("unet.") and "lora_" in n for n in lora)
    assert sum(p.requires_grad for p in pipe.vae.parameters()) == 0
    both = tts.partition_params(pipe, tune_vae=True)
    vae = [n for n in both if n.startswith("vae.")]
    assert len(vae) == len(list(pipe.vae.parameters())) and set(lora) < set(both)


def test_presampled_forward_repeats_forward():
    """Pass 1 run apart (`presample`) and handed to `forward` gives the
    latents, image and LoRA gradients of `forward` running it itself."""
    cfg = tpipe.make_pipeline_config("sd_1_5", lora_rank=RANK, resolution=RES,
                                     tiny=True)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu", seed=4)
    trainable = tts.partition_params(pipe)
    ids = np.random.default_rng(0).integers(0, 1000, (2, 77))
    null = np.zeros((2, 77), np.int64)
    g = torch.Generator().manual_seed(1)
    latents0 = torch.randn(2, 8, 8, 4, generator=g)
    noise = torch.randn(STEPS, 2, 8, 8, 4, generator=g)
    kw = dict(num_inference_steps=STEPS, K=K, latents0=latents0, step_noise=noise)
    runs = []
    for presample in (False, True):
        pre = None
        if presample:
            _, eps_table, traj = pipe.presample(ids, null, **{
                k: v for k, v in kw.items() if k != "K"})
            pre = (eps_table, traj)
        image, res = pipe.forward(ids, null, [1, 3, 5, 7, 9], presampled=pre, **kw)
        image.square().mean().backward()
        runs.append((image.detach(), res.latents.detach(),
                     {n: p.grad.clone() for n, p in trainable.items()}))
        for p in trainable.values():
            p.grad = None
    (im0, lat0, g0), (im1, lat1, g1) = runs
    assert torch.equal(im0, im1) and torch.equal(lat0, lat1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


def test_lora_split_and_merge_round_trip():
    from comat_tpu_torch.models.lora import is_lora_path, merge_params, split_lora_params

    cfg = tpipe.make_pipeline_config("sd_1_5", lora_rank=RANK, resolution=RES,
                                     tiny=True)
    sd = tpipe.DiffusionPipeline(cfg, device="cpu").unet.state_dict()
    parts = split_lora_params(sd)
    assert parts["lora"] and all(is_lora_path(n) for n in parts["lora"])
    assert not any(is_lora_path(n) for n in parts["frozen"])
    assert merge_params(parts["lora"], parts["frozen"]).keys() == sd.keys()
    with pytest.raises(ValueError):
        merge_params(parts["lora"], parts["lora"])
