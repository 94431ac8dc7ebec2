"""The port's SDXL train step against JAX's, at tiny geometry in fp32 on
the CPU: scripts/sdxl.sh's recipe (the BLIP reward, the latent GAN with
an SD1.5-architecture D over the SDXL latents, attribute concentration,
--gradient_checkpointing: block remat and pass 1 unfused).

One jitted JAX program runs `jax.value_and_grad(make_loss_fn(...))` with
the cross-architecture D (`GanConfig(cross_arch=True)`: its own tiny SD1.5
UNet, LoRA rank 4 and the mlp head, conditioned on CLIP-L's final states)
and `make_attrcon_extra_losses` (CenterPrior masks), then `gan_d_loss` and
its gradient into D's trainable leaves at the step's latents, as the
step's D update takes them. Batch 2, 128^2, total_step 10, K 5, A 2, LoRA
rank 4 with nonzero `lora_b` on both sides; the batch carries the second
tokenizer's ids (pad id 0). The injected draws are the JAX step's, as
tests/test_torch_train_full.py replicates them.

Tolerances, the JAX package's whole-step gates (`tools/step_loss_fixture.py`
TOL and GRAD_TOL): each loss component within 1e-3 absolute, each LoRA and
D gradient leaf within 1e-3 relative (max |delta| over max |gradient|).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu import config as jconfig
from comat_tpu.config import BLIPConfig as JBLIPConfig
from comat_tpu.losses import gan as jgan
from comat_tpu.losses.caption_reward import build_caption_batch
from comat_tpu.models import pipeline as jpipe
from comat_tpu.models.blip import BLIPCaptioner as JBLIP
from comat_tpu.segmentation.interface import CenterPriorSegmenter, SegmenterHolder
from comat_tpu.text.tokenizer import HashTokenizer
from comat_tpu.training import attrcon as jattr
from comat_tpu.training import train_step as jts
from comat_tpu_torch.config import BLIPConfig, UNetConfig
from comat_tpu_torch.losses import gan as tgan
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.models.blip import BLIPCaptioner
from comat_tpu_torch.segmentation import interface as tseg
from comat_tpu_torch.training import attrcon as tattr
from comat_tpu_torch.training import train_step as tts
from comat_tpu_torch.weights import from_jax_params

PROMPTS = ["a red car and a blue bird", "two green cats on a mat"]
RES, STEPS, K, A, RANK = 128, 10, 5, 2, 4
LOSS_TOL, GRAD_TOL = 1e-3, 1e-3
COMPONENTS = ["step_loss", "reward_blip", "G_loss", "token_loss", "pixel_loss"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run in parallel worker processes (pytest-xdist);
    one intra-op thread per worker keeps their torch work from
    oversubscribing the cores, which slows every worker many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seeded_params(init, *args, seed=0):
    """A JAX initialiser's parameter tree filled from numpy without running
    the initialiser: kernels N(0, 1/fan_in) with fan_in all dims but the
    last, norm scales 1, other vectors 0, `lora_b` N(0, 0.01) so that the
    LoRA branch counts."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, *args)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "lora_b":
            return jnp.asarray(0.1 * rng.standard_normal(s.shape), s.dtype)
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return jnp.asarray(rng.standard_normal(s.shape) / np.sqrt(fan_in), s.dtype)
        return jnp.full(s.shape, 1.0 if name == "scale" else 0.0, s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _nested(flat):
    out = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _flat(tree):
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    denom = max(np.abs(got).max(), np.abs(want).max(), 1e-12)
    return np.abs(got - want).max() / denom


@pytest.fixture(scope="module")
def case():
    jax.config.update("jax_default_matmul_precision", "highest")
    rng = np.random.default_rng(3)
    pcfg = jpipe.make_pipeline_config("sdxl_attrcon_unet", lora_rank=RANK,
                                      resolution=RES, tiny=True)
    pipe = jpipe.DiffusionPipeline(pcfg)
    params = _seeded_params(pipe.init_params, jax.random.PRNGKey(0), seed=0)
    disc = jgan.Discriminator(jconfig.UNetConfig.tiny(cross_attention_dim=32),
                              jgan.GanConfig(lora_rank=RANK, cross_arch=True))
    d_params = _seeded_params(functools.partial(disc.init_params, latent_size=RES // 8,
                                                context_dim=32),
                              jax.random.PRNGKey(1), seed=4)
    d_params["head"] = {"params": {"mlp": {
        "kernel": jnp.asarray(0.5 * rng.standard_normal((4, 1)), jnp.float32),
        "bias": jnp.asarray(0.1 * rng.standard_normal((1,)), jnp.float32)}}}

    tok, tok2 = HashTokenizer(1000), HashTokenizer(1000, pad_token_id=0)
    enc, null = tok(PROMPTS, max_length=77), tok([""] * 2, max_length=77)
    cap = build_caption_batch(tok, PROMPTS)
    holder = SegmenterHolder(CenterPriorSegmenter(), max_words=4)
    fields = jattr.attrcon_batch_fields(PROMPTS, tok, holder, 77, resolution=RES)
    batch = {
        "input_ids": enc["input_ids"], "eos_positions": enc["eos_positions"],
        "null_ids": null["input_ids"],
        "input_ids2": tok2(PROMPTS, max_length=77)["input_ids"],
        "null_ids2": tok2([""] * 2, max_length=77)["input_ids"],
        "caption_ids": cap["input_ids"],
        "caption_mask": cap["attention_mask"], "caption_labels": cap["labels"],
        "gt_latents": rng.standard_normal((2, RES // 8, RES // 8, 4)).astype(np.float32),
        **fields,
    }
    blip = JBLIP(JBLIPConfig.tiny())
    blip_params = _seeded_params(
        blip.init, jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3)),
        jnp.asarray(cap["input_ids"][:1]), jnp.asarray(cap["attention_mask"][:1]),
        jnp.asarray(cap["labels"][:1]), seed=1)
    jcfg = jts.TrainConfig(total_step=STEPS, K=K, resolution=RES, gan_loss=True,
                           attrcon=True, attrcon_train_steps=A,
                           gradient_checkpointing=True)

    # the draws of the JAX step at state.step == 0, as run_fixture makes them
    rng0 = jax.random.fold_in(jax.random.PRNGKey(5), 0)
    rngs = jax.random.split(rng0, 4)
    trained_idx = np.asarray(jts.sample_trained_idx(rngs[0], jcfg))
    attrcon_draws = np.asarray(jattr.sample_attrcon_draws(rng0, jcfg))
    rng_noise, lrng = jax.random.split(rngs[1])
    h = RES // 8
    latents0 = np.asarray(jax.random.normal(lrng, (2, h, h, 4)))
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng_noise, i),
                                                   (2, h, h, 4))) for i in range(STEPS)])
    crop = tuple(int(jax.random.randint(r, (), 0, RES // 224 + 1)) for r in rngs[2:])

    trainable, frozen = jts.partition_params(params)
    d_trainable, d_frozen = jts.partition_disc_params(d_params)
    extra = jattr.make_attrcon_extra_losses(pipe, holder, jcfg)
    loss_fn = jts.make_loss_fn(pipe, blip, jcfg, extra_losses=extra, disc=disc)
    t_final = jnp.full((4,), 1, jnp.int32)     # inference_timesteps(10)[-1]

    @jax.jit
    def jax_side(trainable, frozen, blip_params, batch, d_trainable, d_frozen):
        d_all = jts.merge_params(d_trainable, d_frozen)
        (_, (metrics, gen)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            trainable, frozen, blip_params, batch, rng0, d_all)
        # a cross-architecture D reads CLIP-L's final states of the null prompts
        null_ctx, _ = pipe.text.apply(jts.merge_params(trainable, frozen)["text"],
                                      batch["null_ids"])
        metrics["D_loss"], d_grads = jax.value_and_grad(lambda tr: jgan.gan_d_loss(
            disc, jts.merge_params(tr, d_frozen), gen, batch["gt_latents"], t_final,
            jax.lax.stop_gradient(null_ctx)))(d_trainable)
        return metrics, grads, d_grads

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics, grads, d_grads = jax_side(trainable, frozen, blip_params, jbatch,
                                       d_trainable, d_frozen)

    g_flat = _flat(grads)
    lora_grads = from_jax_params({"unet": _nested({p[1:]: v for p, v in g_flat.items()
                                                   if p[0] == "unet"})})["unet"]
    weights = from_jax_params(jax.tree_util.tree_map(
        np.asarray, {**params, "blip": blip_params, "disc": d_params}))
    draws = tts.StepDraws(torch.tensor(latents0), torch.tensor(noise),
                          int(trained_idx[0]), crop,
                          tuple(int(i) for i in attrcon_draws))
    return dict(
        batch=batch, weights=weights, draws=draws, jcfg=jcfg,
        metrics={k: float(v) for k, v in metrics.items()}, grads=lora_grads,
        d_grads=from_jax_params({"disc": _nested(_flat(d_grads))})["disc"],
    )


def _port(case):
    cfg = tpipe.make_pipeline_config("sdxl_attrcon_unet", lora_rank=RANK,
                                     resolution=RES, tiny=True)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu", params=case["weights"],
                                   fuse_pass1=False)
    blip = BLIPCaptioner(BLIPConfig.tiny()).requires_grad_(False)
    blip.load_state_dict(case["weights"]["blip"])
    disc = tgan.Discriminator(UNetConfig.tiny(cross_attention_dim=32),
                              tgan.GanConfig(lora_rank=RANK, cross_arch=True),
                              device="cpu")
    disc.load_state_dict(case["weights"]["disc"])
    tcfg = tts.TrainConfig(**{f.name: getattr(case["jcfg"], f.name)
                              for f in dataclasses.fields(tts.TrainConfig)})
    holder = tseg.SegmenterHolder(tseg.CenterPriorSegmenter(), max_words=4)
    extra = tattr.make_attrcon_extra_losses(pipe, holder, tcfg)
    return pipe, blip, disc, tcfg, extra


@pytest.fixture(scope="module")
def port_loss(case):
    pipe, blip, disc, tcfg, extra = _port(case)
    assert tcfg.gradient_checkpointing and pipe.unet_inf is None
    trainable = tts.partition_params(pipe)
    tts.partition_disc_params(disc)
    loss, (metrics, _) = tts.make_loss_fn(pipe, blip, tcfg, extra, disc)(
        case["batch"], case["draws"])
    loss.backward()
    grads = {n[len("unet."):]: p.grad.clone() for n, p in trainable.items()}
    d_untouched = all(p.grad is None for n, p in disc.named_parameters()
                      if "lora_" in n or n.startswith("head."))
    return {k: float(v) for k, v in metrics.items()}, grads, d_untouched


@pytest.mark.parametrize("key", COMPONENTS)
def test_sdxl_loss_components_match_jax(case, port_loss, key):
    got, want = port_loss[0][key], case["metrics"][key]
    assert abs(got - want) <= LOSS_TOL, (key, got, want)


def test_sdxl_lora_gradients_match_jax(case, port_loss):
    grads, want = port_loss[1], case["grads"]
    assert set(grads) == set(want) and len(want) > 0
    worst = max(_rel(grads[n].numpy(), w.numpy()) for n, w in want.items())
    assert worst <= GRAD_TOL, worst
    assert port_loss[2]         # the G loss left D's leaves without gradient


def test_sdxl_cross_arch_d_update_matches_jax(case):
    """One make_train_step: D_loss as JAX's and D's gradients as JAX's at
    the step's own latents, under CLIP-L's final states of the null
    prompts; D shares nothing with the generator."""
    pipe, blip, disc, tcfg, extra = _port(case)
    assert not any(p is q for p in disc.parameters() for q in pipe.unet.parameters())
    state = tts.init_train_state(pipe, tcfg)
    d_state = tts.init_disc_state(disc, tcfg, lr=5e-5)
    seen = {}
    d_step = d_state.optimizer.step

    def recording_step():
        seen.update({n: p.grad.clone().numpy() for n, p in d_state.trainable.items()})
        return d_step()

    d_state.optimizer.step = recording_step
    step = tts.make_train_step(pipe, blip, tcfg, extra, disc, d_state.optimizer)
    _, metrics = step(state, case["batch"], case["draws"])
    assert abs(metrics["D_loss"] - case["metrics"]["D_loss"]) <= LOSS_TOL
    assert set(seen) == set(case["d_grads"]) and "head.mlp.weight" in seen
    worst = max(_rel(g, case["d_grads"][n].numpy()) for n, g in seen.items())
    assert worst <= GRAD_TOL, worst
