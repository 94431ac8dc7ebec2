"""The whole generation slice: the port's `DiffusionPipeline.generate`
against the JAX one at tiny geometry (resolution 64, 3 DDPM steps, CFG
7.5, LoRA rank 4 with nonzero `lora_b`, so the fused path is exercised).

Both get the same weights (`weights.from_jax_params`), the same
`latents0`, and the per-step noise the JAX sampler draws, computed here
with `sampler._step_noise(rng, i, ...)`. Image tolerance 1e-3 absolute in
fp32: three UNet passes and a VAE decode accumulate the 1e-4-level
per-module differences, amplified by the CFG scale of 7.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu.diffusion.sampler import _step_noise
from comat_tpu.models import pipeline as jpipe
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.text.tokenizer import HashTokenizer
from comat_tpu_torch.weights import from_jax_params

PROMPTS = ["a red car and a blue bird", "two green cats on a mat"]
STEPS = 3


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


@pytest.fixture(scope="module")
def case():
    cfg = jpipe.make_pipeline_config("sd_1_5", lora_rank=4, resolution=64,
                                     tiny=True)
    pipe = jpipe.DiffusionPipeline(cfg)
    params = _nonzero_lora_b(pipe.init_params(jax.random.PRNGKey(0)))
    tok = HashTokenizer(cfg.text.vocab_size)
    enc, null = tok(PROMPTS), tok([""] * len(PROMPTS))
    latents0 = np.random.default_rng(7).standard_normal(
        (len(PROMPTS), 8, 8, 4)).astype(np.float32)
    rng = jax.random.PRNGKey(1)
    noise = np.stack([
        np.asarray(_step_noise(rng, i, latents0.shape, jnp.float32))
        for i in range(STEPS)
    ])
    return pipe, params, enc, null, latents0, rng, noise


@pytest.mark.parametrize("kind", ["ddpm", "ddim"])
def test_generate_matches_jax(case, kind):
    jp, params, enc, null, latents0, rng, noise = case
    want = np.asarray(jp.generate(
        params, rng, jnp.asarray(enc["input_ids"]), jnp.asarray(null["input_ids"]),
        num_inference_steps=STEPS, guidance_scale=7.5,
        eos_positions=jnp.asarray(enc["eos_positions"]), kind=kind,
        latents0=jnp.asarray(latents0),
    ))
    cfg = tpipe.make_pipeline_config("sd_1_5", lora_rank=4, resolution=64,
                                     tiny=True)
    pipe = tpipe.DiffusionPipeline(
        cfg, device="cpu",
        params=from_jax_params(jax.tree_util.tree_map(np.asarray, params)),
    )
    got = pipe.generate(
        enc["input_ids"], null["input_ids"], num_inference_steps=STEPS,
        guidance_scale=7.5, eos_positions=enc["eos_positions"], kind=kind,
        latents0=torch.from_numpy(latents0), step_noise=torch.from_numpy(noise),
    )
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_generator_draws_are_reproducible():
    """Without injected noise, one seed gives one image."""
    cfg = tpipe.make_pipeline_config("sd_1_5", lora_rank=0, resolution=64,
                                     tiny=True)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu", seed=5)
    tok = HashTokenizer(cfg.text.vocab_size)
    enc, null = tok(PROMPTS[:1]), tok([""])
    images = [
        pipe.generate(enc["input_ids"], null["input_ids"],
                      num_inference_steps=2,
                      generator=torch.Generator().manual_seed(11))
        for _ in range(2)
    ]
    assert torch.equal(images[0], images[1])


def test_cli_writes_pngs(tmp_path):
    from comat_tpu_torch.tools.generate import main

    images, timings = main([
        "--tiny", "--device", "cpu", "--resolution", "64",
        "--num-inference-steps", "2", "--out-dir", str(tmp_path),
        "--prompt", "a red cube", "a blue ball",
    ])
    assert images.shape == (2, 64, 64, 3)
    assert set(timings) == {"sample_s", "decode_s"}
    for i in range(2):
        data = (tmp_path / f"{i:03d}.png").read_bytes()
        assert data.startswith(b"\x89PNG\r\n\x1a\n") and data.endswith(b"IEND\xaeB`\x82")
