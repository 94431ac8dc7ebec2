"""Each module of the port's generation slice against its JAX
counterpart, at tiny geometry in fp32 on the CPU.

The JAX module is initialised at a seed, its parameters converted with
`jax.tree_util.tree_map(np.asarray, ...)` and loaded into the port with
`weights.from_jax_params`; inputs are made with numpy from a seed.
Tolerances, each from the depth of fp32 arithmetic it covers:
- scheduler tables 1e-7: both compute them in fp64 from the same fp32
  schedule and keep them in fp32, so they are equal;
- CFG 1e-5: a handful of fp32 ops on unit-scale values;
- CLIP 1e-5: two layers of fp32 GEMMs and LayerNorms;
- UNet and VAE 1e-4: tens of GroupNorm/conv/GEMM layers, each summing
  hundreds of products in another order than XLA does.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu import config as jcfg
from comat_tpu.diffusion import guidance as jguid
from comat_tpu.diffusion import schedulers as jsched
from comat_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from comat_tpu.models.lora import fuse_lora_tree
from comat_tpu.models.unet import UNet2DCondition as JUNet
from comat_tpu.models.vae import AutoencoderKL as JVAE
from comat_tpu.text import tokenizer as jtok
from comat_tpu_torch import config as tcfg
from comat_tpu_torch.diffusion import guidance as tguid
from comat_tpu_torch.diffusion import schedulers as tsched
from comat_tpu_torch.models.clip_text import CLIPTextEncoder
from comat_tpu_torch.models.lora import fuse_lora
from comat_tpu_torch.models.unet import UNet2DConditionModel
from comat_tpu_torch.models.vae import AutoencoderKL
from comat_tpu_torch.text import tokenizer as ttok
from comat_tpu_torch.weights import from_jax_params

KEY = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nonzero_lora_b(params, seed=3):
    """LoRA `lora_b` starts at zero; give it values so the branch counts."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        if getattr(path[-1], "key", None) == "lora_b":
            return jnp.asarray(0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(f, params)


# ---- schedulers ----

@pytest.mark.parametrize("kind", ["ddpm", "ddim"])
@pytest.mark.parametrize("steps", [50, 3])
def test_sampler_coeff_tables_equal(kind, steps):
    want = jsched.make_sampler_coeffs(jsched.make_schedule(), steps, kind=kind)
    got = tsched.make_sampler_coeffs(tsched.make_schedule(), steps, kind=kind)
    for field in want._fields:
        np.testing.assert_allclose(
            getattr(got, field), np.asarray(getattr(want, field)),
            atol=1e-7, rtol=0, err_msg=field,
        )


def test_ddpm_step_matches():
    rng = np.random.default_rng(0)
    x, eps, noise = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
                     for _ in range(3))
    jc = jsched.make_sampler_coeffs(jsched.make_schedule(), 50)
    tc = tsched.make_sampler_coeffs(tsched.make_schedule(), 50)
    for i in (0, 25, 49):
        want = jsched.ddpm_step_from_coeffs(
            jc, i, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(noise))
        got = tsched.ddpm_step_from_coeffs(
            tc, i, *map(torch.from_numpy, (x, eps, noise)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


# ---- guidance ----

@pytest.mark.parametrize("rescale", [0.0, 0.7])
def test_cfg_eps_model_matches(rescale):
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    ctx, nctx = (rng.standard_normal((2, 5, 8)).astype(np.float32)
                 for _ in range(2))

    def junet(x, t, c, ac, cap):
        return x * c.mean(axis=(1, 2))[:, None, None, None] + 1e-3 * t, {}

    def tunet(x, t, c):
        return x * c.mean(dim=(1, 2))[:, None, None, None] + 1e-3 * t

    jm = jguid.make_cfg_eps_model(junet, jnp.asarray(ctx), jnp.asarray(nctx),
                                  7.5, rescale)
    tm = tguid.make_cfg_eps_model(tunet, torch.from_numpy(ctx),
                                  torch.from_numpy(nctx), 7.5, rescale)
    want, _ = jm(jnp.asarray(lat), 981)
    got = tm(torch.from_numpy(lat), 981)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ---- UNet with LoRA, fused and not ----

@pytest.fixture(scope="module")
def unet_case():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    model = JUNet(jcfg.UNetConfig.tiny(), lora_rank=4)
    params = model.init(KEY, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1, 77, 32)))
    return x, ctx, _nonzero_lora_b(params)


@pytest.mark.parametrize("fused", [False, True])
def test_unet_matches(unet_case, fused):
    x, ctx, params = unet_case
    t = 981
    if fused:
        jparams = fuse_lora_tree(params)
        model = JUNet(jcfg.UNetConfig.tiny(), lora_rank=0)
    else:
        jparams, model = params, JUNet(jcfg.UNetConfig.tiny(), lora_rank=4)
    want, _ = jax.jit(model.apply)(
        jparams, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    sd = from_jax_params({"unet": _np(params)})["unet"]
    assert any(k.endswith("lora_b") for k in sd)
    if fused:
        sd = fuse_lora(sd)
    unet = UNet2DConditionModel(tcfg.UNetConfig.tiny(), lora_rank=0 if fused else 4)
    unet.load_state_dict(sd)
    with torch.no_grad():
        got = unet(torch.from_numpy(x), t, torch.from_numpy(ctx))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# ---- CLIP ----

def test_clip_matches():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 1000, (2, 77)).astype(np.int32)
    eos = np.array([5, 76], np.int32)
    model = JCLIP(jcfg.CLIPTextConfig.tiny())
    params = model.init(KEY, jnp.zeros((1, 77), jnp.int32))
    want_h, want_p = jax.jit(model.apply)(params, jnp.asarray(ids),
                                          jnp.asarray(eos))
    enc = CLIPTextEncoder(tcfg.CLIPTextConfig.tiny())
    enc.load_state_dict(from_jax_params({"text": _np(params)})["text"])
    with torch.no_grad():
        got_h, got_p = enc(torch.from_numpy(ids).long(), torch.from_numpy(eos))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5, rtol=0)


# ---- VAE decode ----

def test_vae_decode_matches():
    rng = np.random.default_rng(6)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    model = JVAE(jcfg.VAEConfig.tiny())
    params = jax.jit(model.init)(KEY, jnp.zeros((1, 64, 64, 3)))
    want = jax.jit(lambda p, z: model.apply(p, z, method=JVAE.decode))(
        params, jnp.asarray(z))
    vae = AutoencoderKL(tcfg.VAEConfig.tiny())
    vae.load_state_dict(from_jax_params({"vae": _np(params)})["vae"])
    with torch.no_grad():
        got = vae(torch.from_numpy(z))
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# ---- tokenizers ----

PROMPTS = ["a red car and a blue bird", "it's a bear's den...", "",
           "one1 two2 3three   44", "A Red CAR?!"]


def test_hash_tokenizer_ids_equal():
    for vocab in (1000, 49408):
        want = jtok.HashTokenizer(vocab)(PROMPTS)
        got = ttok.HashTokenizer(vocab)(PROMPTS)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_clip_bpe_tokenizer_ids_equal(tmp_path):
    base = list(ttok.bytes_to_unicode().values())
    merges = [("r", "e"), ("re", "d</w>"), ("c", "a"), ("ca", "r</w>"),
              ("b", "l"), ("bl", "u"), ("blu", "e</w>"), ("a", "n")]
    vocab = (base + [b + "</w>" for b in base] + ["".join(m) for m in merges]
             + ["<|startoftext|>", "<|endoftext|>"])
    vpath, mpath = tmp_path / "vocab.json", tmp_path / "merges.txt"
    vpath.write_text(json.dumps({t: i for i, t in enumerate(vocab)}),
                     encoding="utf-8")
    mpath.write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges)
                     + "\n", encoding="utf-8")
    want = jtok.load_clip_tokenizer(str(tmp_path))(PROMPTS)
    got = ttok.load_clip_tokenizer(str(tmp_path))(PROMPTS)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
