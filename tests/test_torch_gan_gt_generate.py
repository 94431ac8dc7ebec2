"""The port's GAN latent generator (`tools/gan_gt_generate.py`) against the
JAX package's, on the CPU at tiny geometry.

- `sample_batch`, fed the initial latents and per-step noise that JAX's
  `pipe.generate(rng, ..., output_type="latent")` draws for a batch of
  JAX's tool (`rng, sub = jax.random.split(rng)`), gives JAX's latents
  within 1e-3 of max abs in fp32 (SD1.5, LoRA rank 4 with nonzero lora_b,
  so that the fused UNet is exercised; one jitted JAX program).
- The CLI at --tiny --device cpu (tests/test_tools.py's
  `test_gan_gt_generate_end_to_end`): 3 prompts at batch 2 make an index
  of 3 lines, read by the port's and JAX's `GanLatentStore` alike, finite
  (8, 8, 4) latents; --use-cache adds no line; --start/--end take their
  slice; the VAE never runs.
- A full-size run without weights or tokenizer refuses before building
  anything unless --allow-smoke.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu.diffusion.sampler import _step_noise, prepare_latents
from comat_tpu.models import pipeline as jpipe
from comat_tpu.training.data import GanLatentStore as JStore
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.models.vae import AutoencoderKL
from comat_tpu_torch.text.tokenizer import HashTokenizer
from comat_tpu_torch.tools import gan_gt_generate as tgan
from comat_tpu_torch.training.data import GanLatentStore
from comat_tpu_torch.weights import from_jax_params

PROMPTS = ["a red car", "a blue bird", "three cats"]
STEPS, RES, B = 3, 64, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per xdist worker, so that parallel test files do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _filled(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "lora_b":
            return np.asarray(0.1 * rng.standard_normal(s.shape), s.dtype)
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return np.asarray(rng.standard_normal(s.shape) / np.sqrt(fan_in), s.dtype)
        if name == "scale":
            return np.ones(s.shape, s.dtype)
        return np.asarray(0.05 * rng.standard_normal(s.shape), s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_sample_batch_with_jax_draws_gives_jax_latents():
    cfg = jpipe.make_pipeline_config("sd_1_5", lora_rank=4, resolution=RES, tiny=True)
    jp = jpipe.DiffusionPipeline(cfg)
    params = _filled(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), 3)
    tok = HashTokenizer(cfg.text.vocab_size)
    enc, null = tok(PROMPTS[:B]), tok([""] * B)

    @jax.jit
    def generate(params, ids, eos, null_ids, rng):
        return jp.generate(params, rng, ids, null_ids, num_inference_steps=STEPS,
                           guidance_scale=7.5, eos_positions=eos, output_type="latent")

    # JAX's tool: rng = PRNGKey(seed), then `rng, sub = split(rng)` a batch
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    want = np.asarray(generate(params, jnp.asarray(enc["input_ids"]),
                               jnp.asarray(enc["eos_positions"]),
                               jnp.asarray(null["input_ids"]), sub))
    # what generate draws from `sub`: the latents, then the step noise
    rest, lrng = jax.random.split(sub)
    latents0 = np.asarray(prepare_latents(lrng, B, RES, RES))
    noise = np.stack([np.asarray(_step_noise(rest, i, latents0.shape, jnp.float32))
                      for i in range(STEPS)])

    tcfg = tpipe.make_pipeline_config("sd_1_5", lora_rank=4, resolution=RES, tiny=True)
    pipe = tpipe.DiffusionPipeline(
        tcfg, device="cpu", params=from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    got = tgan.sample_batch(pipe, pipe.fused_unet(), enc, null, torch.from_numpy(latents0.copy()),
                            torch.from_numpy(noise.copy()), STEPS, 7.5)
    assert got.shape == want.shape == (B, RES // 8, RES // 8, 4) and got.dtype == torch.float32
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def _cli(tmp_path, *extra):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("\n".join(PROMPTS) + "\n")
    return tgan.main(["--model", "sd_1_5", "--tiny", "--device", "cpu", "--prompt-path",
                      str(prompts), "--save-path", str(tmp_path / "store"),
                      "--batch-size", str(B), "--num-inference-steps", str(STEPS),
                      "--resolution", str(RES), *extra])


def _records(tmp_path):
    index = tmp_path / "store" / "index.jsonl"
    return [json.loads(line) for line in index.read_text().splitlines() if line.strip()]


def test_cli_end_to_end_and_resume(tmp_path, monkeypatch):
    def no_decode(*args, **kwargs):
        raise AssertionError("the VAE ran")

    monkeypatch.setattr(AutoencoderKL, "forward", no_decode)
    out = _cli(tmp_path)
    assert out["generated"] == 3 and len(out["batch_s"]) == 2
    recs = _records(tmp_path)
    assert [r["prompt"] for r in recs] == PROMPTS
    assert all(r["file_path"].startswith("latents/") and r["file_path"].endswith(".npy")
               for r in recs)
    index = str(tmp_path / "store" / "index.jsonl")
    for store in (GanLatentStore(index), JStore(index)):
        lat = store.batch(["a red car", "three cats"])
        assert lat.shape == (2, 8, 8, 4) and lat.dtype == np.float32
        assert np.isfinite(lat).all() and np.abs(lat).max() > 0
    np.testing.assert_array_equal(GanLatentStore(index).batch(PROMPTS),
                                  JStore(index).batch(PROMPTS))
    # --use-cache: nothing left to do, nothing added
    assert _cli(tmp_path, "--use-cache")["generated"] == 0
    assert len(_records(tmp_path)) == 3


def test_cli_start_end_shard(tmp_path):
    _cli(tmp_path, "--start", "1", "--end", "3")
    assert [r["prompt"] for r in _records(tmp_path)] == PROMPTS[1:3]
    _cli(tmp_path, "--start", "0", "--end", "1", "--use-cache")
    assert sorted(r["prompt"] for r in _records(tmp_path)) == sorted(PROMPTS)


def test_full_size_refuses_seeded_weights_without_allow_smoke(tmp_path, monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a pipeline was built")

    monkeypatch.setattr(tpipe.DiffusionPipeline, "__init__", no_build)
    prompts = tmp_path / "p.txt"
    prompts.write_text("a red car\n")
    with pytest.raises(SystemExit, match="--allow-smoke"):
        tgan.main(["--prompt-path", str(prompts), "--save-path", str(tmp_path / "s"),
                   "--device", "cpu"])
