"""Attention capture in the port (ops/attention.py `capture_probs`, the
UNet's capture mode, pipeline.forward(capture=...) and the sampler's
`_CaptureOnly`) against the JAX package, at tiny geometry in fp32 on the
CPU.

The JAX pipeline `sd_1_5_attrcon` at tiny width (capture layers mid_2,
up_4, up_8, up_16 at 128^2) with LoRA rank 4 gets its parameters from
numpy at a seed, `lora_b` nonzero; `weights.from_jax_params` carries them
into the port. Inputs come from numpy. Tolerance 1e-4: the maps are fp32
probabilities after tens of fp32 layers, as tests/test_torch_modules.py
holds the UNet; the VJP is held to 1e-4 relative (max |delta| over max
|gradient|) per input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu.models import pipeline as jpipe
from comat_tpu.models.lora import merge_params as jmerge
from comat_tpu.training import train_step as jts
from comat_tpu_torch.diffusion import sampler as tsampler
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.models import unet as tunet
from comat_tpu_torch.training import train_step as tts
from comat_tpu_torch.weights import from_jax_params

RES, RANK, T = 128, 4, 501
TOL = 1e-4


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
    the initialiser (its eager run takes a minute on the CPU): kernels
    N(0, 1/fan_in) with fan_in all dims but the last, norm scales 1, other
    vectors 0, `lora_b` N(0, 0.01) so that the LoRA branch counts."""
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


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    denom = max(np.abs(got).max(), np.abs(want).max(), 1e-12)
    return np.abs(got - want).max() / denom


def _nested(flat):
    out = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


@pytest.fixture(scope="module")
def case():
    jax.config.update("jax_default_matmul_precision", "highest")
    cfg = jpipe.make_pipeline_config("sd_1_5_attrcon", lora_rank=RANK,
                                     resolution=RES, tiny=True)
    pipe = jpipe.DiffusionPipeline(cfg)
    params = _seeded_params(pipe.init_params, jax.random.PRNGKey(0), seed=0)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    trainable, frozen = jts.partition_params(params)

    def primal(tr, lat, c):
        # the cond-half capture primal of pipeline.forward
        _, cap = pipe.unet_apply(jmerge(tr, frozen), lat, jnp.asarray(T), c, None, True,
                                    fast=True)
        return jax.tree_util.tree_map(lambda a: a.astype(cfg.unet.dtype), cap)

    @jax.jit
    def jax_side(tr, lat, c):
        eps, every = pipe.unet.apply(jmerge(tr, frozen)["unet"], lat, jnp.asarray(T), c, None,
                                     capture=True)
        maps, vjp = jax.vjp(primal, tr, lat, c)
        cot = jax.tree_util.tree_map(
            lambda a: jax.random.normal(jax.random.PRNGKey(9), a.shape, a.dtype), maps)
        return eps, every, maps, cot, vjp(cot)

    eps, every, maps, cot, (d_tr, d_x, d_ctx) = jax_side(
        trainable, jnp.asarray(x), jnp.asarray(ctx))
    flat = {
        tuple(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(d_tr)[0]
    }
    d_lora = from_jax_params({"unet": _nested({p[1:]: v for p, v in flat.items()
                                               if p[0] == "unet"})})["unet"]
    np_tree = lambda t: {k: [np.asarray(a) for a in v] for k, v in t.items()}  # noqa: E731
    return dict(
        weights=from_jax_params(jax.tree_util.tree_map(np.asarray, params)),
        x=x, ctx=ctx, eps=np.asarray(eps), every=np_tree(every), maps=np_tree(maps),
        cot=np_tree(cot), d_lora=d_lora, d_x=np.asarray(d_x), d_ctx=np.asarray(d_ctx),
    )


def _port_pipe(case, name="sd_1_5_attrcon"):
    cfg = tpipe.make_pipeline_config(name, lora_rank=RANK, resolution=RES, tiny=True)
    return tpipe.DiffusionPipeline(cfg, device="cpu", params=case["weights"])


def test_attrcon_name_sets_capture():
    """make_pipeline_config honours the `_attrcon` suffix and carries the
    capture layers of JAX's config at both widths."""
    for tiny in (True, False):
        for name in ("sd_1_5", "sd_1_5_attrcon"):
            got = tpipe.make_pipeline_config(name, tiny=tiny)
            want = jpipe.make_pipeline_config(name, tiny=tiny)
            assert (got.attrcon, got.capture_layers) == (want.attrcon, want.capture_layers)
    assert tpipe.make_pipeline_config("sd_1_5_attrcon").capture_layers == jpipe.SD15_CAPTURE


@pytest.mark.parametrize("layers", ["config", "all"])
def test_unet_capture_maps_match_jax(case, layers):
    pipe = _port_pipe(case)
    want = case["maps"] if layers == "config" else case["every"]
    with torch.no_grad():
        if layers == "config":
            eps, got = pipe.unet_apply(torch.from_numpy(case["x"]), T,
                                       torch.from_numpy(case["ctx"]), capture=True)
        else:
            eps, got = pipe.unet(torch.from_numpy(case["x"]), T,
                                 torch.from_numpy(case["ctx"]), capture=True)
    np.testing.assert_allclose(eps.numpy(), case["eps"], atol=TOL, rtol=0)
    assert set(got) == set(want) and len(want) >= 4
    for key, maps in want.items():
        assert len(got[key]) == len(maps)
        for g, w in zip(got[key], maps):
            assert g.shape == w.shape and g.shape[-1] == 77 and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=0)


def test_capture_reads_cross_attention_only(case, monkeypatch):
    """Only attn2 of the captured layers takes the capturing call; every
    self-attention (and every other cross-attention) keeps the dispatching
    call, which sends a CUDA tensor over more than 128 keys to flash."""
    calls = []
    real = tunet.multi_head_attention

    def spy(q, k, v, heads, capture_probs=False):
        calls.append((k.shape[1], capture_probs))
        return real(q, k, v, heads, capture_probs=capture_probs)

    monkeypatch.setattr(tunet, "multi_head_attention", spy)
    pipe = _port_pipe(case)
    with torch.no_grad():
        pipe.unet_apply(torch.from_numpy(case["x"]), T, torch.from_numpy(case["ctx"]),
                        capture=True)
    captured = [s for s, c in calls if c]
    assert captured == [77] * sum(len(v) for v in case["maps"].values())
    assert len(calls) == 2 * 16     # 16 transformer blocks, attn1 and attn2


def test_capture_only_vjp_matches_jax(case):
    """`_CaptureOnly`: its maps, and its VJP into the latents, the context
    and the LoRA factors for a random cotangent, against jax.vjp of JAX's
    cond-half capture primal."""
    pipe = _port_pipe(case)
    trainable = tts.partition_params(pipe)
    x = torch.from_numpy(case["x"]).requires_grad_()
    ctx = torch.from_numpy(case["ctx"]).requires_grad_()

    def capture_primal(lat, t, context):
        return pipe.unet_apply(lat, t, context, capture=True)[1]

    layout = []
    outs = tsampler._CaptureOnly.apply(capture_primal, T, layout, 1, x, ctx,
                                       *trainable.values())
    flat_want = [m for k, _ in layout for m in case["maps"][k]]
    flat_cot = [torch.tensor(c) for k, _ in layout for c in case["cot"][k]]
    assert sorted(k for k, _ in layout) == sorted(case["maps"])
    assert len(outs) == len(flat_want)
    for o, w in zip(outs, flat_want):
        np.testing.assert_allclose(o.detach().numpy(), w, atol=TOL, rtol=0)
    sum((o * c).sum() for o, c in zip(outs, flat_cot)).backward()
    assert _rel(x.grad, case["d_x"]) <= TOL
    assert _rel(ctx.grad, case["d_ctx"]) <= TOL
    worst = max(_rel(p.grad, case["d_lora"][n[len("unet."):]])
                for n, p in trainable.items())
    assert worst <= TOL, worst


def test_forward_captures_at_the_drawn_segments(case):
    """pipeline.forward(capture=True, capture_idx=...) returns each map
    stacked over the draws in their order (a repeat included), each the
    UNet's cond-half capture at its segment's entry latent and timestep;
    gradients flow from the maps to the LoRA factors."""
    pipe = _port_pipe(case)
    trainable = tts.partition_params(pipe)
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 1000, (2, 77))
    null = np.full((2, 77), 2)
    steps, K, trained = 10, 5, [1, 3, 5, 7, 9]
    latents0 = torch.from_numpy(rng.standard_normal((2, 16, 16, 4)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((steps, 2, 16, 16, 4)).astype(np.float32))
    draws = (3, 0, 3)
    image, res = pipe.forward(ids, null, trained, num_inference_steps=steps, K=K,
                              latents0=latents0, step_noise=noise, capture=True,
                              capture_idx=draws)
    assert set(res.captured) == set(pipe.cfg.capture_layers)
    ctx = pipe.encode_prompt(ids).context
    from comat_tpu_torch.diffusion.schedulers import inference_timesteps

    ts_ = inference_timesteps(steps)
    for a, seg in enumerate(draws):
        with torch.no_grad():
            _, want = pipe.unet_apply(res.latents_traj[trained[seg]], int(ts_[trained[seg]]),
                                      ctx, capture=True)
        for key, maps in want.items():
            for got, w in zip(res.captured[key], maps):
                assert got.shape == (len(draws),) + tuple(w.shape)
                torch.testing.assert_close(got[a].detach(), w, atol=1e-6, rtol=0)
    sum(m.sum() for v in res.captured.values() for m in v).backward()
    assert all(p.grad is not None for p in trainable.values())
    assert image.shape == (2, RES, RES, 3)
