"""The port's latent GAN (comat_tpu_torch/losses/gan.py and its wiring in
training/train_step.py) against the JAX one, at tiny geometry in fp32 on
the CPU.

The JAX discriminator is initialised at a seed with LoRA rank 4 and
nonzero `lora_b`, the head drawn from numpy; `weights.from_jax_params`
carries the same tree into the port. Both heads are checked: the mlp
Linear(4 -> 1) and `lastlayer_cls` (a one-channel conv_out).

Tolerances: the losses within 1e-4 absolute, each gradient within 1e-3
relative (max |delta| over max |gradient|, the whole-step gate of
`tools/step_loss_fixture.py`); D's logits within 1e-4 absolute (a tiny
UNet's depth of fp32 arithmetic, as tests/test_torch_modules.py holds
the UNet).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu import config as jcfg
from comat_tpu.losses import gan as jgan
from comat_tpu.training import train_step as jts
from comat_tpu_torch import config as tcfg
from comat_tpu_torch.losses import gan as tgan
from comat_tpu_torch.models.unet import UNet2DConditionModel
from comat_tpu_torch.training import train_step as tts
from comat_tpu_torch.weights import from_jax_params

LOSS_TOL, GRAD_TOL, LOGIT_TOL = 1e-4, 1e-3, 1e-4
RANK, T_FINAL = 4, 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run in parallel worker processes (pytest-xdist);
    one intra-op thread per worker keeps their torch work from
    oversubscribing the cores, which slows every worker many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nonzero_lora_b(params, rng):
    def f(path, leaf):
        if getattr(path[-1], "key", None) == "lora_b":
            return jnp.asarray(0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(f, params)


def _nested(flat):
    out = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    denom = max(np.abs(got).max(), np.abs(want).max(), 1e-12)
    return np.abs(got - want).max() / denom


@pytest.fixture(scope="module", params=[False, True], ids=["mlp", "lastlayer_cls"])
def case(request):
    lastlayer = request.param
    rng = np.random.default_rng(7)
    gan_cfg = jgan.GanConfig(lora_rank=RANK, lastlayer_cls=lastlayer)
    disc = jgan.Discriminator(jcfg.UNetConfig.tiny(), gan_cfg)
    params = _nonzero_lora_b(disc.init_params(jax.random.PRNGKey(1), 8, 32), rng)
    if not lastlayer:
        params["head"] = {"params": {"mlp": {
            "kernel": jnp.asarray(0.5 * rng.standard_normal((4, 1)), jnp.float32),
            "bias": jnp.asarray(0.1 * rng.standard_normal((1,)), jnp.float32)}}}
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    gt = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    t = jnp.full((2,), T_FINAL, jnp.int32)

    trainable, frozen = jts.partition_disc_params(params)

    @jax.jit
    def jax_side(trainable, frozen, lat, gt, ctx):
        params = jts.merge_params(trainable, frozen)
        logits = disc.logits(params, lat, t, ctx)
        g = jax.value_and_grad(lambda x: jgan.gan_g_loss(disc, params, x, t, ctx))(lat)
        d = jax.value_and_grad(lambda tr: jgan.gan_d_loss(
            disc, jts.merge_params(tr, frozen), lat, gt, jnp.concatenate([t, t]),
            ctx))(trainable)
        return logits, g, d

    logits, (g_loss, g_lat), (d_loss, d_grads) = jax_side(
        trainable, frozen, *map(jnp.asarray, (lat, gt, ctx)))
    flat = {
        tuple(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(d_grads)[0]
    }
    grads = from_jax_params({"disc": _nested(flat)})["disc"]

    port = tgan.Discriminator(tcfg.UNetConfig.tiny(),
                              tgan.GanConfig(lora_rank=RANK, lastlayer_cls=lastlayer),
                              device="cpu")
    port.load_state_dict(from_jax_params(
        {"disc": jax.tree_util.tree_map(np.asarray, params)})["disc"])
    return dict(
        lastlayer=lastlayer, port=port, lat=lat, gt=gt, ctx=ctx,
        logits=np.asarray(logits), g_loss=float(g_loss), g_lat=np.asarray(g_lat),
        d_loss=float(d_loss), d_grads=grads,
    )


def test_logits_match_jax(case):
    with torch.no_grad():
        got = case["port"].logits(torch.from_numpy(case["lat"]), T_FINAL,
                                  torch.from_numpy(case["ctx"]))
    assert got.shape == (2, 8, 8, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), case["logits"], atol=LOGIT_TOL, rtol=0)


def test_g_loss_and_latent_gradient_match_jax(case):
    lat = torch.from_numpy(case["lat"]).requires_grad_()
    loss = tgan.gan_g_loss(case["port"], lat, T_FINAL, torch.from_numpy(case["ctx"]))
    loss.backward()
    assert abs(float(loss.detach()) - case["g_loss"]) <= LOSS_TOL
    assert _rel(lat.grad.numpy(), case["g_lat"]) <= GRAD_TOL


def test_d_loss_and_leaf_gradients_match_jax(case):
    port = case["port"]
    trainable = tts.partition_disc_params(port)
    n_lora = sum("lora_" in n for n in trainable)
    assert n_lora > 0 and ("head.mlp.weight" in trainable) != case["lastlayer"]
    assert set(trainable) == set(case["d_grads"])
    for p in trainable.values():
        p.grad = None
    loss = tgan.gan_d_loss(port, torch.from_numpy(case["lat"]),
                           torch.from_numpy(case["gt"]), T_FINAL,
                           torch.from_numpy(case["ctx"]))
    loss.backward()
    assert abs(float(loss.detach()) - case["d_loss"]) <= LOSS_TOL
    worst = max(_rel(p.grad.numpy(), case["d_grads"][n].numpy())
                for n, p in trainable.items())
    assert worst <= GRAD_TOL, worst
    # lora_a's gradients are not zero: lora_b was made nonzero
    assert max(float(p.grad.abs().max()) for n, p in trainable.items()
               if n.endswith("lora_a")) > 0


def test_g_loss_gives_d_no_gradient(case):
    """The G loss reaches the latents and not D: after its backward D's
    trainable leaves hold no gradient and still require one."""
    port = case["port"]
    trainable = tts.partition_disc_params(port)
    for p in trainable.values():
        p.grad = None
    lat = torch.from_numpy(case["lat"]).requires_grad_()
    tgan.gan_g_loss(port, lat, T_FINAL, torch.from_numpy(case["ctx"])).backward()
    assert lat.grad is not None and float(lat.grad.abs().max()) > 0
    assert all(p.grad is None and p.requires_grad for p in trainable.values())


@pytest.mark.parametrize("lastlayer", [False, True])
def test_d_base_is_the_generators_unet(lastlayer):
    """D's frozen base tensors are the generator's UNet tensors, the same
    objects; D's LoRA, head and a one-channel conv_out are its own, and
    partitioning either side leaves the shared tensors frozen."""
    cfg = tcfg.UNetConfig.tiny()
    g_unet = UNet2DConditionModel(cfg, lora_rank=RANK).requires_grad_(False)
    disc = tgan.Discriminator(cfg, tgan.GanConfig(lora_rank=RANK, lastlayer_cls=lastlayer),
                              device="cpu", base_unet=g_unet)
    g_params = dict(g_unet.named_parameters())
    own = []
    for name, p in disc.unet.named_parameters():
        if p is g_params.get(name):
            continue
        own.append(name)
    want_own = {n for n in g_params if "lora_" in n}
    if lastlayer:
        want_own |= {"conv_out.weight", "conv_out.bias"}
    assert set(own) == want_own
    assert all(torch.isfinite(p).all() for p in disc.parameters())
    trainable = tts.partition_disc_params(disc)
    assert all(not p.requires_grad for n, p in g_params.items() if "lora_" not in n)
    assert all(p.requires_grad for p in trainable.values())
    assert not any(p is g_params.get(n[len("unet."):]) for n, p in trainable.items())


def test_d_update_conditions_on_null_prompt_after_g_update():
    """As in JAX (train_step.py:523-524): the G loss conditions D on the
    prompts under `condition_discriminator`, but the D update conditions
    on the null prompts, encoded by the text encoder as the generator's
    update left it."""
    from comat_tpu_torch.config import BLIPConfig
    from comat_tpu_torch.losses.caption_reward import build_caption_batch
    from comat_tpu_torch.models.blip import make_blip
    from comat_tpu_torch.models.pipeline import DiffusionPipeline, make_pipeline_config
    from comat_tpu_torch.text.tokenizer import HashTokenizer

    prompts = ["a red car", "two green cats"]
    cfg = make_pipeline_config("sd_1_5", lora_rank=RANK, resolution=64, tiny=True)
    pipe = DiffusionPipeline(cfg, device="cpu", seed=0)
    blip = make_blip(BLIPConfig.tiny(), device="cpu", seed=1)
    disc = tgan.Discriminator(cfg.unet, tgan.GanConfig(
        lora_rank=RANK, condition_discriminator=True), device="cpu",
        base_unet=pipe.unet, seed=2)
    train = tts.TrainConfig(total_step=4, K=2, resolution=64, gan_loss=True,
                            train_text_encoder=True)
    tok = HashTokenizer(1000)
    enc, null = tok(prompts), tok([""] * 2)
    cap = build_caption_batch(tok, prompts)
    batch = {"input_ids": enc["input_ids"], "eos_positions": enc["eos_positions"],
             "null_ids": null["input_ids"], "caption_ids": cap["input_ids"],
             "caption_mask": cap["attention_mask"], "caption_labels": cap["labels"],
             "gt_latents": np.zeros((2, 8, 8, 4), np.float32)}
    state = tts.init_train_state(pipe, train, tune_text_encoder=True)
    d_state = tts.init_disc_state(disc, train)
    step = tts.make_train_step(pipe, blip, train, disc=disc,
                               d_optimizer=d_state.optimizer)
    probe = next(p for n, p in pipe.text.named_parameters() if n.endswith("final_layer_norm.weight"))
    before = probe.detach().clone()
    calls = []
    encode = pipe.encode_prompt

    def spy(ids, eos=None, train_text_encoder=False):
        calls.append((ids is batch["input_ids"], ids is batch["null_ids"],
                      probe.detach().clone(), torch.is_grad_enabled()))
        return encode(ids, eos, train_text_encoder)

    pipe.encode_prompt = spy
    d_before = {n: p.detach().clone() for n, p in d_state.trainable.items()}
    _, metrics = step(state, batch, generator=torch.Generator().manual_seed(0))
    # forward's prompts and null prompts, the G loss's condition, the D update's
    assert [c[:2] for c in calls] == [(True, False), (False, True), (True, False),
                                      (False, True)]
    assert torch.equal(calls[2][2], before)
    assert not torch.equal(calls[3][2], before)
    assert torch.equal(calls[3][2], probe.detach())
    assert {"G_loss", "D_loss"} <= set(metrics)
    # every leaf moved but those held at zero with a zero gradient: the
    # 1-key self-attention of the 1x1 mid block gives q and k none
    still = [n for n, p in d_state.trainable.items() if torch.equal(d_before[n], p.detach())]
    assert all(not p.detach().any() and not p.grad.any()
               for n, p in d_state.trainable.items() if n in still), still
    assert "head.mlp.weight" not in still and len(still) < len(d_before) // 4
