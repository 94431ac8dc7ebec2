"""The port's SDXL modules against the JAX package's, at tiny geometry in
fp32 on the CPU: the CLIP tower with exact gelu, the penultimate-state
skip and the text projection (OpenCLIP bigG's features); the pipeline's
`encode_prompt` over both towers (the second reading the pad-id-0
tokenizer's ids) and `sdxl_added_cond`; the UNet with the added
condition, its eps and gradients with and without remat, and its
captured maps at SDXL's capture layers; `generate` at 3 DDPM steps.

One jitted JAX program computes every reference, from parameter trees
filled from numpy through `jax.eval_shape` (JAX's eager init takes a
minute). Tolerances: each module output and gradient within 1e-5 of its
max abs; the generated image within 1e-3 absolute, as
tests/test_torch_generate.py holds SD1.5's (three CFG-7.5 UNet passes and
a decode amplify the per-module differences).

The null prompts' pooled embed: JAX takes it at position S - 1, a pad
token of the second tokenizer, not at the first EOS
(comat_tpu/models/pipeline.py:377); the port follows JAX, pinned here by
the pooled embed the port's `forward` hands the UNet for the null prompts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu import config as jconfig
from comat_tpu.diffusion.sampler import _step_noise
from comat_tpu.models import pipeline as jpipe
from comat_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from comat_tpu.text.tokenizer import HashTokenizer
from comat_tpu_torch import config as tconfig
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.models.clip_text import CLIPTextEncoder
from comat_tpu_torch.training import train_step as tts
from comat_tpu_torch.weights import from_jax_params

PROMPTS = ["a red car and a blue bird", "two green cats on a mat"]
RES, RANK, T, STEPS = 128, 4, 481, 3
TOL, IMAGE_TOL = 1e-5, 1e-3


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


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    denom = max(np.abs(got).max(), np.abs(want).max(), 1e-12)
    return np.abs(got - want).max() / denom


def _big_g_tiny():
    """The tiny tower with bigG's features: exact gelu and a projection."""
    return dataclasses.replace(jconfig.CLIPTextConfig.tiny(), hidden_act="gelu",
                               projection_dim=24)


@pytest.fixture(scope="module")
def case():
    jax.config.update("jax_default_matmul_precision", "highest")
    rng = np.random.default_rng(11)
    pcfg = jpipe.make_pipeline_config("sdxl_attrcon", lora_rank=RANK, resolution=RES,
                                      tiny=True)
    pipe = jpipe.DiffusionPipeline(pcfg)
    params = _seeded_params(pipe.init_params, jax.random.PRNGKey(0), seed=0)
    tower = JCLIP(_big_g_tiny())
    tower_params = _seeded_params(tower.init, jax.random.PRNGKey(1),
                                  jnp.zeros((1, 77), jnp.int32), seed=1)
    tok, tok2 = HashTokenizer(1000), HashTokenizer(1000, pad_token_id=0)
    enc, null = tok(PROMPTS), tok([""] * 2)
    ids2, null2 = tok2(PROMPTS)["input_ids"], tok2([""] * 2)["input_ids"]
    h = RES // 8
    x = rng.standard_normal((2, h, h, 4)).astype(np.float32)
    cot = rng.standard_normal((2, h, h, 4)).astype(np.float32)
    latents0 = rng.standard_normal((2, h, h, 4)).astype(np.float32)
    gen_rng = jax.random.PRNGKey(3)
    noise = np.stack([np.asarray(_step_noise(gen_rng, i, latents0.shape, jnp.float32))
                      for i in range(STEPS)])
    lora = lambda tree: jax.tree_util.tree_map_with_path(  # noqa: E731
        lambda p, v: v if "lora_" in str(getattr(p[-1], "key", "")) else None, tree)

    @jax.jit
    def jax_side(params, tower_params, ids, eos, null_ids, ids2, null_ids2, x, cot,
                 latents0):
        out = {}
        for skip in (0, 1):
            out[f"tower_hidden{skip}"], out["tower_pooled"] = tower.apply(
                tower_params, ids2, eos, output_hidden_state_skip=skip)
        e = pipe.encode_prompt(params, ids, eos, ids2)
        n = pipe.encode_prompt(params, null_ids, None, null_ids2)
        out.update(context=e.context, pooled=e.pooled, null_context=n.context,
                   null_pooled=n.pooled,
                   null_pooled_at_eos=pipe.encode_prompt(
                       params, null_ids, jnp.ones((2,), jnp.int32), null_ids2).pooled)
        added = pipe.sdxl_added_cond(e.pooled, 2)
        out["time_ids"] = added["time_ids"]
        t = jnp.asarray(T)

        def eps_loss(unet_params, x):
            p = dict(params, unet=unet_params)
            eps, _ = pipe.unet_apply(p, x, t, e.context, added)
            return jnp.sum(eps * cot), eps

        (_, out["eps"]), (g_unet, out["d_x"]) = jax.value_and_grad(
            eps_loss, argnums=(0, 1), has_aux=True)(params["unet"], x)
        out["d_lora"] = lora(g_unet)
        _, out["maps"] = pipe.unet_apply(params, x, t, e.context, added, True)
        out["image"] = pipe.generate(params, gen_rng, ids, null_ids,
                                     num_inference_steps=STEPS, guidance_scale=7.5,
                                     eos_positions=eos, input_ids2=ids2,
                                     null_ids2=null_ids2, latents0=latents0)
        return out

    out = jax_side(params, tower_params, *(jnp.asarray(a) for a in (
        enc["input_ids"], enc["eos_positions"], null["input_ids"], ids2, null2, x, cot,
        latents0)))
    out = jax.tree_util.tree_map(np.asarray, out)
    flat = {tuple(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(out.pop("d_lora"))[0]}
    out["d_lora"] = from_jax_params({"unet": _nested(flat)})["unet"]
    weights = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    weights["tower"] = from_jax_params({"text2": jax.tree_util.tree_map(
        np.asarray, tower_params)})["text2"]
    return dict(out=out, weights=weights, ids=enc["input_ids"], eos=enc["eos_positions"],
                null_ids=null["input_ids"], ids2=ids2, null2=null2, x=x, cot=cot,
                latents0=latents0, noise=noise)


def _pipe(case):
    cfg = tpipe.make_pipeline_config("sdxl_attrcon", lora_rank=RANK, resolution=RES,
                                     tiny=True)
    return tpipe.DiffusionPipeline(cfg, device="cpu", params=case["weights"])


def test_big_g_tower_matches_jax(case):
    """Exact gelu, the penultimate states without the final LayerNorm, and
    the pooled output through the fp32 text projection (transposed from
    JAX's (hidden, proj))."""
    cfg = dataclasses.replace(tconfig.CLIPTextConfig.tiny(), hidden_act="gelu",
                              projection_dim=24)
    tower = CLIPTextEncoder(cfg).requires_grad_(False)
    tower.load_state_dict(case["weights"]["tower"])
    assert tower.text_projection.weight.shape == (24, 32)
    ids, eos = torch.from_numpy(case["ids2"]).long(), torch.from_numpy(case["eos"])
    for skip in (0, 1):
        hidden, pooled = tower(ids, eos, output_hidden_state_skip=skip)
        assert _rel(hidden, case["out"][f"tower_hidden{skip}"]) <= TOL, skip
        assert _rel(pooled, case["out"]["tower_pooled"]) <= TOL
    assert _rel(case["out"]["tower_hidden0"], case["out"]["tower_hidden1"]) > 0.1


@pytest.mark.parametrize("which", ["prompts", "null"])
def test_encode_prompt_and_added_cond_match_jax(case, which):
    pipe = _pipe(case)
    if which == "prompts":
        e = pipe.encode_prompt(case["ids"], case["eos"], input_ids2=case["ids2"])
        want_ctx, want_pooled = case["out"]["context"], case["out"]["pooled"]
    else:
        e = pipe.encode_prompt(case["null_ids"], None, input_ids2=case["null2"])
        want_ctx, want_pooled = case["out"]["null_context"], case["out"]["null_pooled"]
    assert e.context.shape == (2, 77, 64) and e.pooled.shape == (2, 32)
    assert _rel(e.context, want_ctx) <= TOL
    assert _rel(e.pooled, want_pooled) <= TOL
    added = pipe.sdxl_added_cond(e.pooled, 2)
    assert added["text_embeds"] is e.pooled
    np.testing.assert_array_equal(added["time_ids"].numpy(), case["out"]["time_ids"])
    np.testing.assert_array_equal(added["time_ids"][0].numpy(), [RES, RES, 0, 0, RES, RES])


def _added(pipe, case):
    e = pipe.encode_prompt(case["ids"], case["eos"], input_ids2=case["ids2"])
    return e.context, pipe.sdxl_added_cond(e.pooled, 2)


@pytest.mark.parametrize("remat", [False, True])
def test_unet_with_added_cond_matches_jax(case, remat):
    """eps, and the VJP of a random cotangent into the latents and every
    LoRA factor, checkpointed (remat) or not."""
    pipe = _pipe(case)
    trainable = tts.partition_params(pipe)
    ctx, added = _added(pipe, case)
    x = torch.from_numpy(case["x"]).requires_grad_()
    eps = pipe.unet_apply(x, T, ctx, added, remat=remat)
    assert _rel(eps.detach(), case["out"]["eps"]) <= TOL
    (eps * torch.from_numpy(case["cot"])).sum().backward()
    assert _rel(x.grad, case["out"]["d_x"]) <= TOL
    want = case["out"]["d_lora"]
    assert len(want) == len(trainable) and len(want) > 0
    worst = max(_rel(p.grad, want[n[len("unet."):]]) for n, p in trainable.items())
    assert worst <= TOL, worst


def test_unet_captures_sdxl_layers_as_jax(case):
    pipe = _pipe(case)
    ctx, added = _added(pipe, case)
    with torch.no_grad():
        eps, maps = pipe.unet_apply(torch.from_numpy(case["x"]), T, ctx, added,
                                    capture=True)
    want = case["out"]["maps"]
    assert set(maps) == set(want) == set(tpipe.TINY_XL_CAPTURE)
    assert _rel(eps, case["out"]["eps"]) <= TOL
    for key, ms in want.items():
        assert len(maps[key]) == len(ms)
        for g, w in zip(maps[key], ms):
            assert g.shape == w.shape and g.shape[-1] == 77
            assert _rel(g, w) <= TOL, key


def test_unet_without_added_cond_raises(case):
    pipe = _pipe(case)
    with pytest.raises(ValueError, match="added_cond"):
        pipe.unet_apply(torch.from_numpy(case["x"]), T,
                        torch.zeros(2, 77, 64))


def test_generate_matches_jax(case):
    pipe = _pipe(case)
    img = pipe.generate(case["ids"], case["null_ids"], num_inference_steps=STEPS,
                        guidance_scale=7.5, eos_positions=case["eos"],
                        input_ids2=case["ids2"], null_ids2=case["null2"],
                        latents0=torch.from_numpy(case["latents0"]),
                        step_noise=torch.from_numpy(case["noise"]))
    want = case["out"]["image"]
    assert img.shape == want.shape == (2, RES, RES, 3)
    assert np.abs(img.numpy() - want).max() <= IMAGE_TOL


def test_null_pooled_embed_is_taken_at_the_last_position_as_jax(case, monkeypatch):
    """The pooled embed `forward` gives the UNet for the null prompts is
    tower 2's output at S - 1 (a pad token), JAX's, and not the one at the
    null prompt's first EOS (position 1), which differs from it."""
    pipe = _pipe(case)
    seen = []
    real = pipe.sdxl_added_cond

    def spy(pooled, batch, *args, **kw):
        seen.append(pooled.detach().clone())
        return real(pooled, batch, *args, **kw)

    monkeypatch.setattr(pipe, "sdxl_added_cond", spy)
    s = RES // 8
    with torch.no_grad():
        pipe.forward(case["ids"], case["null_ids"], [0], num_inference_steps=2, K=1,
                     eos_positions=case["eos"], input_ids2=case["ids2"],
                     null_ids2=case["null2"], latents0=torch.zeros(2, s, s, 4),
                     step_noise=torch.zeros(2, 2, s, s, 4))
    prompts_pooled, null_pooled = seen
    assert _rel(prompts_pooled, case["out"]["pooled"]) <= TOL
    assert _rel(null_pooled, case["out"]["null_pooled"]) <= TOL
    at_eos = case["out"]["null_pooled_at_eos"]
    assert _rel(null_pooled, at_eos) > 100 * TOL
