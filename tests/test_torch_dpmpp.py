"""DPM-Solver++ 2M in the port (`diffusion.schedulers.sample_dpmpp_2m`,
`DiffusionPipeline.generate(kind="dpmpp")`, the generate CLI's
`--scheduler dpmpp`) against the JAX package at tiny geometry (64^2,
5 steps, CFG 7.5, LoRA rank 4 with nonzero `lora_b`, fp32 on the CPU).

Same weights (`weights.from_jax_params` of a tree filled from numpy
through `jax.eval_shape`), same `latents0`; DPM++ draws no noise. Image
tolerance 1e-3 absolute, as tests/test_torch_generate.py holds DDPM:
five UNet passes and a decode accumulate the 1e-4-level per-module
differences, amplified by the CFG scale. The sampler alone, on a linear
eps model, is held to 1e-5 relative: fp32 arithmetic in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu.diffusion import schedulers as jsched
from comat_tpu.models import pipeline as jpipe
from comat_tpu_torch.diffusion import schedulers as tsched
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.text.tokenizer import HashTokenizer
from comat_tpu_torch.tools.generate import main as generate_main
from comat_tpu_torch.weights import from_jax_params

PROMPTS = ["a red car and a blue bird", "two green cats on a mat"]
STEPS = 5


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
    last, norm scales 1, other vectors 0, `lora_b` N(0, 0.01)."""
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


def test_dpmpp_sampler_matches_jax():
    """eps = 0.3 x + 0.1 t/1000 (the model's output depends on x and t),
    50 steps: the final latents within 1e-5 relative."""
    x0 = np.random.default_rng(1).standard_normal((2, 8, 8, 4)).astype(np.float32)
    want = jsched.sample_dpmpp_2m(
        lambda x, t, cap: (0.3 * x + 0.1 * t / 1000.0, None), jsched.make_schedule(),
        50, jnp.asarray(x0))
    got = tsched.sample_dpmpp_2m(lambda x, t: 0.3 * x + 0.1 * t / 1000.0,
                                 tsched.make_schedule(), 50, torch.from_numpy(x0))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_generate_dpmpp_matches_jax():
    cfg = jpipe.make_pipeline_config("sd_1_5", lora_rank=4, resolution=64, tiny=True)
    jp = jpipe.DiffusionPipeline(cfg)
    params = _seeded_params(jp.init_params, jax.random.PRNGKey(0))
    tok = HashTokenizer(cfg.text.vocab_size)
    enc, null = tok(PROMPTS), tok([""] * len(PROMPTS))
    latents0 = np.random.default_rng(7).standard_normal(
        (len(PROMPTS), 8, 8, 4)).astype(np.float32)
    want = np.asarray(jp.generate(
        params, jax.random.PRNGKey(1), jnp.asarray(enc["input_ids"]),
        jnp.asarray(null["input_ids"]), num_inference_steps=STEPS, guidance_scale=7.5,
        eos_positions=jnp.asarray(enc["eos_positions"]), kind="dpmpp",
        latents0=jnp.asarray(latents0)))
    pipe = tpipe.DiffusionPipeline(
        tpipe.make_pipeline_config("sd_1_5", lora_rank=4, resolution=64, tiny=True),
        device="cpu", params=from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    got = pipe.generate(enc["input_ids"], null["input_ids"], num_inference_steps=STEPS,
                        guidance_scale=7.5, eos_positions=enc["eos_positions"],
                        kind="dpmpp", latents0=torch.from_numpy(latents0))
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_generate_cli_takes_dpmpp(tmp_path):
    images, _ = generate_main(["--tiny", "--device", "cpu", "--resolution", "64",
                               "--num-inference-steps", "3", "--scheduler", "dpmpp",
                               "--out-dir", str(tmp_path), "--prompt", "a red cube"])
    assert images.shape == (1, 64, 64, 3) and torch.isfinite(images).all()
    assert (tmp_path / "000.png").is_file()
