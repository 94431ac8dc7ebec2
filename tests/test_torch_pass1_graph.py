"""Pass 1 without a blocking upload a call, on the CPU: a timestep tensor
on the latents' device reaches the UNet without the "unet.timesteps"
sync and gives the int's eps; `sample_inference` uploads its timesteps
once and equals the per-call loop bit for bit; `v_to_eps` reads a device
table; and where no CUDA graph may run (CPU tensors, a grad-enabled
context, a host timestep, an installed int8 weight set, tensor-parallel
layers) the pass-1 eps model runs eagerly and `pass1_graph_share` reads
0. The graph itself is `tests/test_torch_pass1_graph_cuda.py`'s, on the
card."""

import numpy as np
import pytest
import torch

from comat_tpu_torch import trace
from comat_tpu_torch.diffusion import pass1_graph
from comat_tpu_torch.diffusion.sampler import sample_inference
from comat_tpu_torch.diffusion.schedulers import (
    ddpm_step_from_coeffs,
    make_sampler_coeffs,
    v_to_eps,
)
from comat_tpu_torch.models import quant
from comat_tpu_torch.models.pipeline import DiffusionPipeline, make_pipeline_config
from comat_tpu_torch.text.tokenizer import HashTokenizer
from comat_tpu_torch.trace import PhaseClock
from comat_tpu_torch.training.train_step import trace_outputs

CPU = torch.device("cpu")
STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pipe():
    return DiffusionPipeline(make_pipeline_config("sd_1_5", lora_rank=4, resolution=64,
                                                  tiny=True), device="cpu", seed=3)


def _inputs(pipe, B=2, seed=0):
    tok = HashTokenizer(1000)
    enc = tok(["a red cube", "two blue birds"][:B], max_length=77)
    null = tok([""] * B, max_length=77)
    with torch.no_grad():
        ctx = pipe.encode_prompt(enc["input_ids"], enc["eos_positions"]).context
        nctx = pipe.encode_prompt(null["input_ids"]).context
    g = torch.Generator().manual_seed(seed)
    s = pipe.cfg.latent_size
    lat = torch.randn(B, s, s, 4, generator=g)
    noise = torch.randn(STEPS, B, s, s, 4, generator=g)
    return enc, null, ctx, nctx, lat, noise


def _syncs(clock):
    return [s.name for s in clock.spans if s.kind == "sync"]


@pytest.mark.parametrize("shape", [(), (2,)])
def test_a_device_timestep_tensor_gives_the_int_eps_and_opens_no_sync(pipe, shape):
    _, _, ctx, _, lat, _ = _inputs(pipe)
    t = 741
    unet = pipe.fused_unet()
    clock = PhaseClock(CPU)
    with torch.no_grad(), clock.active():
        want = unet(lat, t, ctx)
        assert _syncs(clock) == ["unet.timesteps"]
        got = unet(lat, torch.full(shape, t, dtype=torch.long), ctx)
    assert _syncs(clock) == ["unet.timesteps"]
    assert torch.isfinite(want).all() and torch.equal(got, want)


def _per_call_loop(eps_model, coeffs, x, step_noise):
    """The sampler as it was: an int timestep a call, the tables stacked."""
    eps_table, traj = [], []
    for i in range(len(coeffs.timesteps)):
        eps = eps_model(x, int(coeffs.timesteps[i]))
        traj.append(x)
        eps_table.append(eps)
        x, _ = ddpm_step_from_coeffs(coeffs, i, x, eps, step_noise[i])
    return x, torch.stack(eps_table), torch.stack(traj)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_sample_inference_uploads_its_timesteps_once_and_equals_the_per_call_loop(
        prediction_type):
    p = DiffusionPipeline(make_pipeline_config("sd_1_5", lora_rank=4, resolution=64, tiny=True,
                                               prediction_type=prediction_type),
                          device="cpu", seed=5)
    _, _, ctx, nctx, lat, noise = _inputs(p, seed=1)
    model = p._pass1_eps_model(ctx, nctx, 7.5, 0.0, p._pass1_unet())
    coeffs = make_sampler_coeffs(p.schedule, STEPS)
    clock = PhaseClock(CPU)
    with torch.no_grad():
        want = _per_call_loop(model.eager, coeffs, lat, noise)
        with clock.active():
            got = sample_inference(model, coeffs, lat, step_noise=noise)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    syncs = _syncs(clock)
    assert syncs.count("sampler.timesteps") == 1 and "unet.timesteps" not in syncs
    assert len(clock.marks["unet>"]) == STEPS
    assert clock.tallies == {"pass1_eager": STEPS}


def test_sample_inference_draws_its_noise_from_the_generator_in_order(pipe):
    _, _, ctx, nctx, lat, _ = _inputs(pipe, seed=2)
    model = pipe._pass1_eps_model(ctx, nctx, 7.5, 0.0, pipe._pass1_unet())
    coeffs = make_sampler_coeffs(pipe.schedule, STEPS)
    g = torch.Generator().manual_seed(9)
    noise = torch.stack([torch.randn(lat.shape, generator=g) for _ in range(STEPS)])
    with torch.no_grad():
        want = _per_call_loop(model.eager, coeffs, lat, noise)
        got = sample_inference(model, coeffs, lat, torch.Generator().manual_seed(9))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("t", [17, 981, "tensor0", "tensorB"])
def test_v_to_eps_reads_a_table_on_the_device_as_it_reads_the_schedule(pipe, t):
    x = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(4))
    v = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(5))
    ts = {"tensor0": torch.tensor(333), "tensorB": torch.tensor([12, 900])}.get(t, t)
    acp = pipe._alphas_cumprod(CPU)
    assert pipe._alphas_cumprod(CPU) is acp           # uploaded once
    want = v_to_eps(pipe.schedule, ts, x, v)
    assert torch.equal(v_to_eps(pipe.schedule, ts, x, v, acp), want)
    if isinstance(t, int):
        assert torch.equal(v_to_eps(pipe.schedule, torch.tensor(t), x, v, acp), want)
        a = np.sqrt(pipe.schedule.alphas_cumprod[t])
        s = np.sqrt(1.0 - pipe.schedule.alphas_cumprod[t])
        np.testing.assert_allclose(want.numpy(), a * v.numpy() + s * x.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_cpu_latents_never_build_a_graph_and_the_share_reads_zero(pipe):
    enc, null, _, _, lat, noise = _inputs(pipe, seed=3)
    before = pass1_graph.CAPTURES
    clock = PhaseClock(CPU)
    with clock.active():
        pipe.presample(enc["input_ids"], null["input_ids"], num_inference_steps=STEPS,
                       eos_positions=enc["eos_positions"], latents0=lat, step_noise=noise)
        pipe.generate(enc["input_ids"], null["input_ids"], num_inference_steps=STEPS,
                      eos_positions=enc["eos_positions"], latents0=lat, step_noise=noise,
                      output_type="latent")
    clock.close()
    assert pass1_graph.CAPTURES == before and pipe.pass1_graph._graph is None
    assert clock.tallies == {"pass1_eager": 2 * STEPS}
    out = trace_outputs(clock)
    assert out["pass1_graph_share"] == 0.0 and out["n_pass1_captures"] == float(before)


def test_the_share_is_replays_over_guided_calls():
    clock = PhaseClock(CPU)
    with clock.active():
        for _ in range(3):
            trace.tally("pass1_graph")
        trace.tally("pass1_eager")
        trace.tally("pass1_capture")
    clock.close()
    assert trace_outputs(clock)["pass1_graph_share"] == 0.75
    trace.tally("pass1_graph")             # no active clock: nothing counted
    assert clock.tallies == {"pass1_graph": 3, "pass1_eager": 1, "pass1_capture": 1}


@pytest.mark.parametrize("case", ["grad", "host_int", "int8", "tp", "plain"])
def test_the_graph_is_refused_where_the_input_forbids_it(pipe, monkeypatch, case):
    _, _, ctx, nctx, lat, _ = _inputs(pipe, seed=4)
    unet = pipe._pass1_unet()
    model = pipe._pass1_eps_model(ctx, nctx, 7.5, 0.0, unet)
    # the latents as if on the card, so that the other conditions show here
    monkeypatch.setattr(pass1_graph, "_on_card", lambda x: True)
    t = 5 if case == "host_int" else torch.tensor(5)
    if case == "tp":
        monkeypatch.setattr(unet.down_blocks[0].attentions[0].transformer_blocks[0]
                            .attn1.to_out[0], "tp_group", object(), raising=False)
    with torch.set_grad_enabled(case == "grad"):
        if case == "int8":
            with quant.installed(unet, quant.quantize_unet(unet)):
                key = model._key(lat, t)
        else:
            key = model._key(lat, t)
    if case == "plain":
        assert key is not None and key[0] == model._fixed and model._fixed
    else:
        assert key is None
