"""v-prediction (--prediction_type v_prediction) in the port against the
JAX package, at tiny geometry in fp32 on the CPU.

- `diffusion.schedulers.v_to_eps` against JAX's `v_to_eps` on the same
  numpy inputs, one timestep and one a sample: equal to 1 ulp.
- The SD1.5 step with a v-prediction pipeline against JAX's step: the loss
  within 1e-3 absolute, every LoRA leaf's gradient and post-step value
  within 1e-3 relative (`torch_step_parity`, JAX's TOL / GRAD_TOL).
- The site JAX reaches through `unet_apply` and the port does not: the
  port's pass 1 calls its UNet directly, so its eps table must convert v
  too. The first row of a v-prediction presample's table equals the guided
  eps through `unet_apply` (converted), not the guided raw output.
- `make_pipeline_config` refuses another prediction type, as JAX's does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu.diffusion import schedulers as jsched
from comat_tpu_torch.diffusion import schedulers as tsched
from comat_tpu_torch.diffusion.guidance import make_cfg_eps_model
from comat_tpu_torch.diffusion.schedulers import inference_timesteps
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.text.tokenizer import HashTokenizer
from torch_step_parity import assert_step_matches, jax_case, port_pipeline, port_step

RES, STEPS, K, RANK = 64, 4, 2, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per xdist worker (see tests/test_torch_text_lora.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _v_pred(cfg):
    return dataclasses.replace(cfg, prediction_type="v_prediction")


@pytest.mark.parametrize("t", [981, [981, 21, 500]])
def test_v_to_eps_matches_jax(t):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    v = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    want = jsched.v_to_eps(jsched.make_schedule(), jnp.asarray(t), jnp.asarray(x),
                           jnp.asarray(v))
    got = tsched.v_to_eps(tsched.make_schedule(), t, torch.tensor(x), torch.tensor(v))
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.all(np.abs(got.numpy() - want) <= np.spacing(np.abs(want)))


def test_v_prediction_step_matches_jax():
    case = jax_case("sd_1_5", RES, STEPS, K, RANK, edit_cfg=_v_pred)
    assert case["pcfg"].prediction_type == "v_prediction"
    pipe, blip, tcfg = port_pipeline(case, "sd_1_5", RANK, edit_cfg=_v_pred)
    assert pipe.cfg.prediction_type == "v_prediction"
    metrics, grads, after, _ = port_step(pipe, blip, tcfg, case["batch"], case["draws"])
    assert_step_matches(case, metrics, grads, after, must=("unet.",))


def test_pass1_converts_v_to_eps():
    cfg = _v_pred(tpipe.make_pipeline_config("sd_1_5", lora_rank=RANK, resolution=RES,
                                             tiny=True))
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu")
    tok = HashTokenizer(1000)
    enc, null = tok(["a red cube"], max_length=77), tok([""], max_length=77)
    g = torch.Generator().manual_seed(0)
    lat = torch.randn(1, 8, 8, 4, generator=g)
    noise = torch.randn(STEPS, 1, 8, 8, 4, generator=g)
    _, eps_table, _ = pipe.presample(enc["input_ids"], null["input_ids"],
                                     num_inference_steps=STEPS,
                                     eos_positions=enc["eos_positions"], latents0=lat,
                                     step_noise=noise)
    ctx = pipe.encode_prompt(enc["input_ids"], enc["eos_positions"]).context
    nctx = pipe.encode_prompt(null["input_ids"]).context
    t0 = int(inference_timesteps(STEPS)[0])
    with torch.no_grad():
        converted = make_cfg_eps_model(
            lambda l, t, c: pipe.unet_apply(l, t, c, fused=True), ctx, nctx, 7.5)(lat, t0)
        raw = make_cfg_eps_model(lambda l, t, c: pipe.unet_inf(l, t, c), ctx, nctx, 7.5)(
            lat, t0)
    assert torch.equal(eps_table[0], converted)
    assert (eps_table[0] - raw).abs().max() > 1e-2


def test_unknown_prediction_type_raises():
    with pytest.raises(ValueError, match="prediction_type"):
        tpipe.make_pipeline_config("sd_1_5", tiny=True, prediction_type="sample")
