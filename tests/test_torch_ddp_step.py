"""The port's data-parallel step at world 2 against JAX's step at the
global batch on a two-device data mesh, at tiny geometry in fp32 on the
CPU.

JAX runs one jitted program on `make_mesh(data=2)` (two of the conftest's
host devices), the batch of 4 prompts sharded over 'data' and the
parameters replicated: the reward-only loss and its gradients, and the
full recipe's (the latent GAN with its D gradients, attribute
concentration with CenterPrior masks), with the JAX step's own draws. The
port runs `make_train_step(mesh=)` in two processes over Gloo, each on
its 2 rows of the batch and its rows of the same global draws. The two
ranks' captions hold different numbers of scored tokens (asserted), so
the caption loss is a token-weighted mean across ranks: the mean of the
ranks' own means parts from JAX's loss by more than the tolerance
(witnessed), the port's token-count shares do not.

--norm_grad rescales the reward's image gradient by 1e4 / reward_norm, a
factor outside the differentiated path: JAX's gradient under it is its
reward-only gradient times that factor, from the same program.

Tolerances: the JAX package's whole-step gates
(`tests/torch_step_parity.py::assert_step_matches`, TOL and GRAD_TOL
1e-3); D's gradients within GRAD_TOL relative.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from comat_tpu import config as jconfig
from comat_tpu.config import BLIPConfig as JBLIPConfig
from comat_tpu.losses import gan as jgan
from comat_tpu.losses.caption_reward import build_caption_batch
from comat_tpu.models import pipeline as jpipe
from comat_tpu.models.blip import BLIPCaptioner as JBLIP
from comat_tpu.parallel.mesh import make_mesh, replicate_tree, shard_batch
from comat_tpu.segmentation.interface import CenterPriorSegmenter, SegmenterHolder
from comat_tpu.text.tokenizer import HashTokenizer
from comat_tpu.training import attrcon as jattr
from comat_tpu.training import train_step as jts
from comat_tpu.training.trainer import Trainer
from comat_tpu_torch.config import BLIPConfig
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.models.blip import BLIPCaptioner
from comat_tpu_torch.training import train_step as tts
from comat_tpu_torch.weights import from_jax_params
from torch_dist import run_ranks, step_rank
from torch_step_parity import (
    GRAD_TOL,
    LOSS_TOL,
    _flat,
    _nested,
    assert_step_matches,
    by_port_name,
    rel,
    seeded_params,
)

PROMPTS = ["a red car and a blue bird", "two green cats on a mat",
           "a small yellow dog sleeping beside an old wooden fence", "sky"]
RES, STEPS, K, A, RANK = 128, 6, 3, 2, 4
NAME = "sd_1_5_attrcon"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(kind):
    kw = dict(total_step=STEPS, K=K, resolution=RES)
    if kind == "full":
        kw.update(gan_loss=True, attrcon=True, attrcon_train_steps=A)
    return jts.TrainConfig(**kw)


@pytest.fixture(scope="module")
def case():
    jax.config.update("jax_default_matmul_precision", "highest")
    rng = np.random.default_rng(3)
    pcfg = jpipe.make_pipeline_config(NAME, lora_rank=RANK, resolution=RES, tiny=True)
    pipe = jpipe.DiffusionPipeline(pcfg)
    params = seeded_params(pipe.init_params, jax.random.PRNGKey(0), seed=0)
    disc = jgan.Discriminator(jconfig.UNetConfig.tiny(), jgan.GanConfig(lora_rank=RANK))
    d_params = seeded_params(functools.partial(disc.init_params, latent_size=RES // 8,
                                               context_dim=32), jax.random.PRNGKey(1), seed=4)
    d_params["head"] = {"params": {"mlp": {
        "kernel": jnp.asarray(0.5 * rng.standard_normal((4, 1)), jnp.float32),
        "bias": jnp.asarray(0.1 * rng.standard_normal((1,)), jnp.float32)}}}
    d_params = Trainer._share_base_unet(d_params, params)
    B = len(PROMPTS)
    tok = HashTokenizer(1000)
    enc, null = tok(PROMPTS, max_length=77), tok([""] * B, max_length=77)
    cap = build_caption_batch(tok, PROMPTS)
    holder = SegmenterHolder(CenterPriorSegmenter(), max_words=4)
    fields = jattr.attrcon_batch_fields(PROMPTS, tok, holder, 77, resolution=RES)
    batch = {
        "input_ids": enc["input_ids"], "eos_positions": enc["eos_positions"],
        "null_ids": null["input_ids"], "caption_ids": cap["input_ids"],
        "caption_mask": cap["attention_mask"], "caption_labels": cap["labels"],
        "gt_latents": rng.standard_normal((B, RES // 8, RES // 8, 4)).astype(np.float32),
        **fields,
    }
    blip = JBLIP(JBLIPConfig.tiny())
    blip_params = seeded_params(
        blip.init, jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3)),
        jnp.asarray(cap["input_ids"][:1]), jnp.asarray(cap["attention_mask"][:1]),
        jnp.asarray(cap["labels"][:1]), seed=1)
    cfg_r, cfg_f = _cfg("reward"), _cfg("full")

    # the draws of the JAX step at state.step == 0 for the global batch
    rng0 = jax.random.fold_in(jax.random.PRNGKey(5), 0)
    rngs = jax.random.split(rng0, 4)
    trained_idx = np.asarray(jts.sample_trained_idx(rngs[0], cfg_f))
    attrcon_draws = np.asarray(jattr.sample_attrcon_draws(rng0, cfg_f))
    rng_noise, lrng = jax.random.split(rngs[1])
    h = RES // 8
    latents0 = np.asarray(jax.random.normal(lrng, (B, h, h, 4)))
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng_noise, i),
                                                   (B, h, h, 4))) for i in range(STEPS)])
    crop = tuple(int(jax.random.randint(r, (), 0, RES // 224 + 1)) for r in rngs[2:])

    trainable, frozen = jts.partition_params(params)
    d_trainable, d_frozen = jts.partition_disc_params(d_params)
    loss_r = jts.make_loss_fn(pipe, blip, cfg_r)
    loss_f = jts.make_loss_fn(pipe, blip, cfg_f, disc=disc,
                              extra_losses=jattr.make_attrcon_extra_losses(pipe, holder, cfg_f))
    t_final = jnp.full((2 * B,), 1, jnp.int32)     # inference_timesteps(STEPS)[-1]

    @jax.jit
    def jax_side(trainable, frozen, blip_params, batch, d_trainable, d_frozen):
        (_, (m_r, _)), g_r = jax.value_and_grad(loss_r, has_aux=True)(
            trainable, frozen, blip_params, batch, rng0, None)
        d_all = jts.merge_params(d_trainable, d_frozen)
        (_, (m_f, gen)), g_f = jax.value_and_grad(loss_f, has_aux=True)(
            trainable, frozen, blip_params, batch, rng0, d_all)
        null_ctx = jax.lax.stop_gradient(pipe.encode_prompt(
            jts.merge_params(trainable, frozen), batch["null_ids"]).context)
        m_f["D_loss"], d_grads = jax.value_and_grad(lambda tr: jgan.gan_d_loss(
            disc, jts.merge_params(tr, d_frozen), gen, batch["gt_latents"], t_final,
            null_ctx))(d_trainable)
        return m_r, g_r, m_f, g_f, d_grads

    mesh = make_mesh(data=2, devices=jax.devices()[:2])
    out = jax_side(replicate_tree(trainable, mesh), replicate_tree(frozen, mesh),
                   replicate_tree(blip_params, mesh),
                   shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh),
                   replicate_tree(d_trainable, mesh), replicate_tree(d_frozen, mesh))
    m_r, g_r, m_f, g_f, d_grads = jax.device_get(out)
    norm = float(m_r["reward_norm"])
    g_n = jax.tree_util.tree_map(lambda g: g * (1e4 / max(norm, 1e-12)), g_r)

    def step_case(cfg, metrics, grads):
        opt = jts.make_optimizer(cfg)
        updates, _ = opt.update(grads, opt.init(trainable), trainable)
        return dict(jcfg=cfg, loss=float(metrics["step_loss"]),
                    metrics={k: float(v) for k, v in metrics.items()},
                    grads=by_port_name(grads), before=by_port_name(trainable),
                    after=by_port_name(optax.apply_updates(trainable, updates)))

    weights = from_jax_params(jax.tree_util.tree_map(
        np.asarray, {**params, "blip": blip_params, "disc": d_params}))
    return dict(
        batch=batch, weights=weights,
        draws=tts.StepDraws(torch.tensor(latents0), torch.tensor(noise),
                            int(trained_idx[0]), crop,
                            tuple(int(i) for i in attrcon_draws)),
        reward=step_case(cfg_r, m_r, g_r),
        norm_grad=step_case(dataclasses.replace(cfg_r, norm_grad=True), m_r, g_n),
        full=step_case(cfg_f, m_f, g_f),
        d_grads=from_jax_params({"disc": _nested(_flat(d_grads))})["disc"],
        d_loss=float(m_f["D_loss"]),
    )


def _port(case, kind):
    sub = case[kind]
    draws = case["draws"]
    if kind != "full":
        draws = draws._replace(attrcon_draws=())
    train = {f.name: getattr(sub["jcfg"], f.name) for f in dataclasses.fields(tts.TrainConfig)}
    spec = dict(name=NAME, res=RES, lora_rank=RANK, weights=case["weights"],
                batch=case["batch"], draws=draws, train=train,
                gan=kind == "full", attrcon=kind == "full")
    return run_ranks(step_rank, 2, spec)


@pytest.fixture(scope="module")
def ranks(case):
    return {kind: _port(case, kind) for kind in ("reward", "norm_grad", "full")}


@pytest.mark.parametrize("kind", ["reward", "norm_grad", "full"])
def test_world2_step_matches_jax_at_the_global_batch(case, ranks, kind):
    (m0, g0, a0, _, _), (m1, g1, a1, _, _) = ranks[kind]
    values = [{k: v for k, v in m.items() if not k.startswith("s_")} for m in (m0, m1)]
    assert values[0] == values[1]      # every rank reports the global metrics
    for n in g0:                       # and holds the same gradients and update
        np.testing.assert_array_equal(g0[n], g1[n])
        np.testing.assert_array_equal(a0[n], a1[n])
    assert_step_matches(case[kind], m0, g0, a0, must=("unet.",))
    for key in ("reward_blip", "reward_norm", "G_loss", "token_loss", "pixel_loss"):
        if key in case[kind]["metrics"]:
            assert abs(m0[key] - case[kind]["metrics"][key]) <= LOSS_TOL * max(
                1.0, abs(case[kind]["metrics"][key])), key


def test_world2_d_update_matches_jax(case, ranks):
    (m0, _, _, d0, _), (_, _, _, d1, _) = ranks["full"]
    assert abs(m0["D_loss"] - case["d_loss"]) <= LOSS_TOL
    assert set(d0) == set(case["d_grads"]) and "head.mlp.weight" in d0
    worst = max(rel(g, case["d_grads"][n].numpy()) for n, g in d0.items())
    assert worst <= GRAD_TOL, worst
    for n in d0:
        np.testing.assert_array_equal(d0[n], d1[n])


def test_token_weighted_caption_loss_is_witnessed(case, ranks):
    """The ranks' captions hold different token counts, and the mean of
    the two halves' own losses (each half's caption mean, as a per-rank
    mean would make it) misses JAX's loss by more than TOL, where the
    port's world-2 step does not."""
    (m0, *_, n0), (_, *_, n1) = ranks["reward"]
    assert n0 != n1
    sub = case["reward"]
    cfg = tpipe.make_pipeline_config(NAME, lora_rank=RANK, resolution=RES, tiny=True)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu", params=case["weights"])
    blip = BLIPCaptioner(BLIPConfig.tiny()).requires_grad_(False)
    blip.load_state_dict(case["weights"]["blip"])
    tcfg = tts.TrainConfig(**{f.name: getattr(sub["jcfg"], f.name)
                              for f in dataclasses.fields(tts.TrainConfig)})
    loss_fn = tts.make_loss_fn(pipe, blip, tcfg)
    draws = case["draws"]._replace(attrcon_draws=())
    halves = []
    with torch.no_grad():
        for r in range(2):
            rows = slice(2 * r, 2 * r + 2)
            half = {k: v[rows] for k, v in case["batch"].items()}
            d = draws._replace(latents0=draws.latents0[rows],
                               step_noise=draws.step_noise[:, rows])
            halves.append(float(loss_fn(half, d)[0]))
    want = sub["loss"]
    assert abs(m0["step_loss"] - want) <= LOSS_TOL
    assert abs(sum(halves) / 2 - want) > LOSS_TOL, (halves, want)
