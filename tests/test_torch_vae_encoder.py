"""The VAE encoder in the port (`models.vae.Encoder`,
`AutoencoderKL.encode`, `weights.from_jax_params` of the encoder leaves)
against JAX's `VAEEncoder`, and `tune_vae`'s weight decay of the encoder
against JAX's optimizer, at tiny geometry in fp32 on the CPU.

The JAX AutoencoderKL tree is filled from numpy through `jax.eval_shape`.
Encoder: mean and logvar within 1e-4 absolute (fp32 convs, GroupNorm and
attention in another order, as tests/test_torch_modules.py holds the
decoder), also where the logvar clip acts. Decay: JAX marks the whole
`vae` subtree under `tune_vae`; the step never runs the encoder, so its
gradient is zero and AdamW's weight decay alone moves it. After one port
step the encoder leaves equal JAX's optimizer (`make_optimizer`, clip and
AdamW) applied to the same leaves with zero gradients, within 1e-6
relative (the same fp32 update in another order); lr 0.1 makes the decay
(1e-3 of each leaf) stand well above that bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from comat_tpu.config import VAEConfig as JVAEConfig
from comat_tpu.models import pipeline as jpipe
from comat_tpu.models.vae import AutoencoderKL as JVAE
from comat_tpu.training import train_step as jts
from comat_tpu_torch.config import BLIPConfig, VAEConfig
from comat_tpu_torch.losses.caption_reward import build_caption_batch
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.models.blip import BLIPCaptioner
from comat_tpu_torch.models.vae import AutoencoderKL
from comat_tpu_torch.text.tokenizer import HashTokenizer
from comat_tpu_torch.training import train_step as tts
from comat_tpu_torch.weights import from_jax_params, init_weights_

ENC_TOL, DECAY_TOL = 1e-4, 1e-6


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
    last, norm scales 1 + N(0, 0.01), biases N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, *args)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return jnp.asarray(rng.standard_normal(s.shape) / np.sqrt(fan_in), s.dtype)
        base = 1.0 if name == "scale" else 0.0
        return jnp.asarray(base + 0.1 * rng.standard_normal(s.shape), s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("clip", [False, True])
def test_encoder_matches_jax(clip):
    """`clip`: the logvar half of quant_conv's bias set to +-40, so that
    logvar crosses both ends of [-30, 20]."""
    model = JVAE(JVAEConfig.tiny())
    params = _seeded_params(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    if clip:
        bias = np.asarray(params["params"]["encoder"]["quant_conv"]["bias"]).copy()
        bias[4:] = [40.0, -40.0, 40.0, -40.0]
        params["params"]["encoder"]["quant_conv"]["bias"] = jnp.asarray(bias)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    mean, logvar = model.apply(params, jnp.asarray(x), method=JVAE.encode)
    vae = AutoencoderKL(VAEConfig.tiny())
    vae.load_state_dict(from_jax_params(
        {"vae": jax.tree_util.tree_map(np.asarray, params)})["vae"])
    with torch.no_grad():
        got_mean, got_logvar = vae.encode(torch.from_numpy(x))
    assert got_mean.shape == got_logvar.shape == (2, 8, 8, 4)
    if clip:
        assert float(got_logvar.max()) == 20.0 and float(got_logvar.min()) == -30.0
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(mean), atol=ENC_TOL, rtol=0)
    np.testing.assert_allclose(got_logvar.numpy(), np.asarray(logvar), atol=ENC_TOL,
                               rtol=0)


def test_tune_vae_decays_the_encoder_as_jax_does():
    jcfg = jpipe.make_pipeline_config("sd_1_5", lora_rank=4, resolution=64, tiny=True)
    params = _seeded_params(jpipe.DiffusionPipeline(jcfg).init_params,
                            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    cfg = tpipe.make_pipeline_config("sd_1_5", lora_rank=4, resolution=64, tiny=True)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu", params=from_jax_params(params))
    blip = BLIPCaptioner(BLIPConfig.tiny()).requires_grad_(False)
    init_weights_(blip, torch.Generator().manual_seed(1))
    tcfg = tts.TrainConfig(total_step=4, K=2, resolution=64, learning_rate=0.1)
    state = tts.init_train_state(pipe, tcfg, tune_vae=True)
    enc = {n for n in state.trainable if n.startswith(("vae.encoder.", "vae.quant_conv."))}
    assert len(enc) == len(list(pipe.vae.encoder.parameters())) + 2
    tok = HashTokenizer(1000)
    prompts = ["a red car", "two green cats"]
    e, null = tok(prompts), tok([""] * 2)
    cap = build_caption_batch(tok, prompts)
    batch = {"input_ids": e["input_ids"], "eos_positions": e["eos_positions"],
             "null_ids": null["input_ids"], "caption_ids": cap["input_ids"],
             "caption_mask": cap["attention_mask"], "caption_labels": cap["labels"]}
    state, metrics = tts.make_train_step(pipe, blip, tcfg)(
        state, batch, generator=torch.Generator().manual_seed(2))
    assert np.isfinite(metrics["step_loss"])

    encoder = {"params": {"encoder": params["vae"]["params"]["encoder"]}}
    jcfg_t = jts.TrainConfig(total_step=4, K=2, resolution=64, learning_rate=0.1)
    opt = jts.make_optimizer(jcfg_t)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, encoder)
    updates, _ = opt.update(zeros, opt.init(encoder), encoder)
    want = from_jax_params({"vae": optax.apply_updates(encoder, updates)})["vae"]
    before = from_jax_params({"vae": encoder})["vae"]
    assert {f"vae.{n}" for n in want} == enc
    for n, w in want.items():
        got = state.trainable[f"vae.{n}"].detach()
        scale = max(float(w.abs().max()), 1e-12)
        assert float((got - w).abs().max()) <= DECAY_TOL * scale, n
        if float(before[n].abs().max()) > 0:
            assert not torch.equal(got, before[n]), n
