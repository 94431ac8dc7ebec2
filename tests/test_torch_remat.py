"""Remat and the memory-tight flag in the port (`TrainConfig.
gradient_checkpointing`, `remat_min_res`; models/remat.py, the UNet's and
the decoder's checkpointed blocks, pass 1 unfused) against the JAX
package, at tiny geometry in fp32 on the CPU.

One jitted JAX program, shared through a module-scoped fixture:
`jax.value_and_grad(make_loss_fn(...))` of JAX's step with
`gradient_checkpointing=True` (block remat in the replay, the decoder
per block, pass 1 with the LoRA branch unfused) and attribute
concentration on (CenterPrior masks, A 2), batch 2, 128^2, total_step 10,
K 5, LoRA rank 4 with nonzero `lora_b`. Its parameter tree is filled
from numpy through `jax.eval_shape`; the draws are the JAX step's, as
`tools/step_loss_fixture.run_fixture` replicates them. Tolerances, those
of the JAX package's whole-step gates: the loss and each component within
1e-3 absolute, each LoRA gradient leaf within 1e-3 relative (max |delta|
over max |gradient|).

The other tests need no JAX compile: remat alone changes no value (bit
for bit on the CPU), `remat_min_res` checkpoints the blocks JAX's
`_remat_at` picks (read from JAX's traced program), and under the flag
the pipeline holds no LoRA-free twin and pass 1 runs the LoRA'd UNet.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu.config import BLIPConfig as JBLIPConfig
from comat_tpu.config import UNetConfig as JUNetConfig
from comat_tpu.losses.caption_reward import build_caption_batch
from comat_tpu.models import pipeline as jpipe
from comat_tpu.models.blip import BLIPCaptioner as JBLIP
from comat_tpu.models.unet import UNet2DCondition as JUNet
from comat_tpu.segmentation.interface import CenterPriorSegmenter, SegmenterHolder
from comat_tpu.text.tokenizer import HashTokenizer
from comat_tpu.training import attrcon as jattr
from comat_tpu.training import train_step as jts
from comat_tpu_torch.config import BLIPConfig, UNetConfig
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.models import remat as trm
from comat_tpu_torch.models.blip import BLIPCaptioner
from comat_tpu_torch.models.unet import UNet2DConditionModel
from comat_tpu_torch.segmentation import interface as tseg
from comat_tpu_torch.training import attrcon as tattr
from comat_tpu_torch.training import train_step as tts
from comat_tpu_torch.weights import from_jax_params, init_weights_

PROMPTS = ["a red car and a blue bird", "two green cats on a mat"]
RES, STEPS, K, A, RANK = 128, 10, 5, 2, 4
LOSS_TOL, GRAD_TOL = 1e-3, 1e-3
COMPONENTS = ["step_loss", "reward_blip", "token_loss", "pixel_loss"]


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


@pytest.fixture(scope="module")
def case():
    jax.config.update("jax_default_matmul_precision", "highest")
    pcfg = jpipe.make_pipeline_config("sd_1_5_attrcon", lora_rank=RANK,
                                      resolution=RES, tiny=True)
    pipe = jpipe.DiffusionPipeline(pcfg)
    params = _seeded_params(pipe.init_params, jax.random.PRNGKey(0), seed=0)
    tok = HashTokenizer(1000)
    enc, null = tok(PROMPTS, max_length=77), tok([""] * 2, max_length=77)
    cap = build_caption_batch(tok, PROMPTS)
    holder = SegmenterHolder(CenterPriorSegmenter(), max_words=4)
    fields = jattr.attrcon_batch_fields(PROMPTS, tok, holder, 77, resolution=RES)
    batch = {
        "input_ids": enc["input_ids"], "eos_positions": enc["eos_positions"],
        "null_ids": null["input_ids"], "caption_ids": cap["input_ids"],
        "caption_mask": cap["attention_mask"], "caption_labels": cap["labels"],
        **fields,
    }
    blip = JBLIP(JBLIPConfig.tiny())
    blip_params = _seeded_params(
        blip.init, jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3)),
        jnp.asarray(cap["input_ids"][:1]), jnp.asarray(cap["attention_mask"][:1]),
        jnp.asarray(cap["labels"][:1]), seed=1)
    jcfg = jts.TrainConfig(total_step=STEPS, K=K, resolution=RES, attrcon=True,
                           attrcon_train_steps=A, gradient_checkpointing=True)

    rng0 = jax.random.fold_in(jax.random.PRNGKey(5), 0)
    rngs = jax.random.split(rng0, 4)
    trained_idx = np.asarray(jts.sample_trained_idx(rngs[0], jcfg))
    attrcon_draws = np.asarray(jattr.sample_attrcon_draws(rng0, jcfg))
    rng_noise, lrng = jax.random.split(rngs[1])
    h = RES // 8
    latents0 = np.asarray(jax.random.normal(lrng, (2, h, h, 4)))
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng_noise, i),
                                                   (2, h, h, 4))) for i in range(STEPS)])
    crop = tuple(int(jax.random.randint(r, (), 0, RES // 224 + 1)) for r in rngs[2:])

    trainable, frozen = jts.partition_params(params)
    loss_fn = jts.make_loss_fn(pipe, blip, jcfg,
                               extra_losses=jattr.make_attrcon_extra_losses(pipe, holder, jcfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, (metrics, _)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        trainable, frozen, blip_params, jbatch, rng0, None)

    flat = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    lora_grads = from_jax_params({"unet": _nested({p[1:]: v for p, v in flat.items()
                                                   if p[0] == "unet"})})["unet"]
    weights = from_jax_params(jax.tree_util.tree_map(
        np.asarray, {**params, "blip": blip_params}))
    draws = tts.StepDraws(torch.tensor(latents0), torch.tensor(noise),
                          int(trained_idx[0]), crop,
                          tuple(int(i) for i in attrcon_draws))
    return dict(batch=batch, weights=weights, draws=draws, jcfg=jcfg,
                metrics={k: float(v) for k, v in metrics.items()}, grads=lora_grads)


@pytest.fixture(scope="module")
def port_loss(case):
    cfg = tpipe.make_pipeline_config("sd_1_5_attrcon", lora_rank=RANK, resolution=RES,
                                     tiny=True)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu", params=case["weights"],
                                   fuse_pass1=False)
    blip = BLIPCaptioner(BLIPConfig.tiny()).requires_grad_(False)
    blip.load_state_dict(case["weights"]["blip"])
    tcfg = tts.TrainConfig(**{f.name: getattr(case["jcfg"], f.name)
                              for f in dataclasses.fields(tts.TrainConfig)})
    assert tcfg.gradient_checkpointing
    holder = tseg.SegmenterHolder(tseg.CenterPriorSegmenter(), max_words=4)
    trainable = tts.partition_params(pipe)
    loss, (metrics, _) = tts.make_loss_fn(
        pipe, blip, tcfg, tattr.make_attrcon_extra_losses(pipe, holder, tcfg))(
        case["batch"], case["draws"])
    loss.backward()
    grads = {n[len("unet."):]: p.grad.clone() for n, p in trainable.items()}
    return {k: float(v) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("key", COMPONENTS)
def test_remat_step_loss_matches_jax(case, port_loss, key):
    got, want = port_loss[0][key], case["metrics"][key]
    assert abs(got - want) <= LOSS_TOL, (key, got, want)


def test_remat_step_lora_gradients_match_jax(case, port_loss):
    grads, want = port_loss[1], case["grads"]
    assert set(grads) == set(want) and len(want) == 256
    worst = max(_rel(grads[n].numpy(), w.numpy()) for n, w in want.items())
    assert worst <= GRAD_TOL, worst


# ---- the port alone ----

SMALL = 64


def _small_pipe(fuse_pass1=True):
    cfg = tpipe.make_pipeline_config("sd_1_5", lora_rank=RANK, resolution=SMALL,
                                     tiny=True)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu", seed=3, fuse_pass1=fuse_pass1)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for n, p in pipe.unet.named_parameters():
            if n.endswith("lora_b"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    blip = BLIPCaptioner(BLIPConfig.tiny()).requires_grad_(False)
    init_weights_(blip, torch.Generator().manual_seed(5))
    return pipe, blip


def _small_batch():
    tok = HashTokenizer(1000)
    enc, null = tok(PROMPTS, max_length=77), tok([""] * 2, max_length=77)
    cap = build_caption_batch(tok, PROMPTS)
    return {"input_ids": enc["input_ids"], "eos_positions": enc["eos_positions"],
            "null_ids": null["input_ids"], "caption_ids": cap["input_ids"],
            "caption_mask": cap["attention_mask"], "caption_labels": cap["labels"]}


def _loss_and_grads(pipe, blip, cfg, draws):
    trainable = tts.partition_params(pipe)
    for p in trainable.values():
        p.grad = None
    loss, (_, latents) = tts.make_loss_fn(pipe, blip, cfg)(_small_batch(), draws)
    loss.backward()
    return loss.detach(), latents.detach(), {n: p.grad.clone() for n, p in trainable.items()}


def test_remat_alone_changes_no_value():
    """`remat_min_res` without the flag: JAX still fuses pass 1, and the
    checkpointed blocks (UNet at res >= 4, every decoder resnet) give the
    loss, the latents and every LoRA gradient of the step without remat,
    bit for bit."""
    pipe, blip = _small_pipe()
    cfg = tts.TrainConfig(total_step=STEPS, K=K, resolution=SMALL)
    draws = tts.sample_draws(cfg, 2, SMALL // 8, torch.Generator().manual_seed(6))
    base = _loss_and_grads(pipe, blip, cfg, draws)
    seen = []
    real = trm.checkpoint

    def recording(fn, *args, **kw):
        seen.append(type(fn).__name__)
        return real(fn, *args, **kw)

    trm.checkpoint = recording
    try:
        remat = _loss_and_grads(pipe, blip, dataclasses.replace(cfg, remat_min_res=4),
                                draws)
    finally:
        trm.checkpoint = real
    assert "ResnetBlock2D" in seen and "Transformer2DModel" in seen
    assert "VAEResnetBlock" in seen
    assert torch.equal(base[0], remat[0]) and torch.equal(base[1], remat[1])
    assert base[2].keys() == remat[2].keys()
    assert all(torch.equal(base[2][n], remat[2][n]) for n in base[2])


def _jax_remat_picks(remat):
    """(kind, resolution) of each block JAX's tiny UNet wraps in remat,
    read from its traced program: each `nn.remat` block is one checkpoint
    equation whose activation input is (B, H, W, C) with B = 5; a
    transformer's also takes the (B, 77, D) context."""
    unet = JUNet(JUNetConfig.tiny(), lora_rank=RANK)
    B, h = 5, RES // 8
    lat, ctx = jnp.zeros((B, h, h, 4)), jnp.zeros((B, 77, 32))
    t = jnp.full((B,), 10, jnp.int32)
    params = jax.eval_shape(unet.init, jax.random.PRNGKey(0), lat, t, ctx)
    jaxpr = jax.make_jaxpr(lambda p: unet.apply(p, lat, t, ctx, remat=remat))(params)
    picks = []
    for eqn in jaxpr.jaxpr.eqns:
        if eqn.primitive.name not in ("checkpoint", "remat", "remat2"):
            continue
        shapes = [v.aval.shape for v in eqn.invars]
        res = next(s[1] for s in shapes if len(s) == 4 and s[0] == B)
        kind = "transformer" if (B, 77, 32) in shapes else "resnet"
        picks.append((kind, res))
    return sorted(picks)


@pytest.mark.parametrize("remat", [True, 8, 16])
def test_remat_min_res_picks_the_blocks_jax_picks(remat):
    unet = UNet2DConditionModel(UNetConfig.tiny(), lora_rank=RANK)
    torch.nn.init.zeros_(unet.conv_in.weight)
    picks = []
    real = trm.checkpoint

    def recording(fn, h, *args, **kw):
        kind = "transformer" if type(fn).__name__ == "Transformer2DModel" else "resnet"
        picks.append((kind, h.shape[2]))
        return real(fn, h, *args, **kw)

    trm.checkpoint = recording
    try:
        lat = torch.zeros(5, RES // 8, RES // 8, 4, requires_grad=True)
        unet(lat, 10, torch.zeros(5, 77, 32), remat=remat).sum().backward()
    finally:
        trm.checkpoint = real
    want = _jax_remat_picks(remat)
    assert want and sorted(picks) == want


def test_flag_builds_no_twin_and_pass1_runs_the_lora_unet():
    """Under gradient_checkpointing the pipeline holds no LoRA-free twin
    and the step's 10 pass-1 CFG calls run the LoRA'd UNet without
    gradients; with the flag off the twin runs them. A step under the
    flag on a pipeline that holds a twin is refused: pass 1 would fuse."""
    cfg = tts.TrainConfig(total_step=STEPS, K=K, resolution=SMALL)
    draws = tts.sample_draws(cfg, 2, SMALL // 8, torch.Generator().manual_seed(6))
    for flag in (True, False):
        pipe, blip = _small_pipe(fuse_pass1=not flag)
        assert (pipe.unet_inf is None) == flag
        calls = {"lora": 0, "twin": 0}
        pipe.unet.register_forward_hook(
            lambda m, a, o: calls.__setitem__("lora", calls["lora"] + (not torch.is_grad_enabled())))
        if pipe.unet_inf is not None:
            pipe.unet_inf.register_forward_hook(
                lambda m, a, o: calls.__setitem__("twin", calls["twin"] + 1))
        _loss_and_grads(pipe, blip, dataclasses.replace(cfg, gradient_checkpointing=flag),
                        draws)
        assert calls == ({"lora": STEPS, "twin": 0} if flag else {"lora": 0, "twin": STEPS})
    with pytest.raises(ValueError, match="fuse_pass1=False"):
        tts.make_loss_fn(pipe, blip, dataclasses.replace(cfg, gradient_checkpointing=True))


def test_generate_reuses_a_fused_unet_without_a_twin():
    """A pipeline without a twin samples with the fused UNet its caller
    made once (`fused_unet()`, as validation does for all its prompts):
    the images of `generate` making its own, bit for bit, at every call."""
    pipe, _ = _small_pipe(fuse_pass1=False)
    assert pipe.unet_inf is None
    tok = HashTokenizer(1000)
    enc, null = tok(PROMPTS, max_length=77), tok([""], max_length=77)
    unet = pipe.fused_unet()
    assert unet is not pipe.unet and unet is not pipe.fused_unet()
    for i in range(2):
        kw = dict(num_inference_steps=3, eos_positions=enc["eos_positions"][i:i + 1])
        want = pipe.generate(enc["input_ids"][i:i + 1], null["input_ids"],
                             generator=torch.Generator().manual_seed(i), **kw)
        got = pipe.generate(enc["input_ids"][i:i + 1], null["input_ids"],
                            generator=torch.Generator().manual_seed(i), unet=unet, **kw)
        assert torch.equal(got, want)


def test_captured_maps_pass_through_the_checkpoint():
    """A captured transformer block under remat returns its maps through
    the checkpoint: the same maps, eps and input gradient as without
    remat, bit for bit."""
    unet = UNet2DConditionModel(UNetConfig.tiny(), lora_rank=RANK)
    init_weights_(unet, torch.Generator().manual_seed(7))
    for n, p in unet.named_parameters():
        p.requires_grad_("lora_" in n)
    g = torch.Generator().manual_seed(8)
    lat0, ctx = torch.randn(2, 16, 16, 4, generator=g), torch.randn(2, 77, 32, generator=g)
    out = []
    for remat in (False, True):
        lat = lat0.clone().requires_grad_()
        eps, maps = unet(lat, 10, ctx, capture=True, capture_layers=("up_8", "up_16"),
                         remat=remat)
        loss = eps.square().sum() + sum(m.square().sum() for v in maps.values() for m in v)
        loss.backward()
        out.append((eps.detach(), {k: [m.detach() for m in v] for k, v in maps.items()},
                    lat.grad))
    (e0, m0, g0), (e1, m1, g1) = out
    assert set(m0) == set(m1) == {"up_8", "up_16"}
    assert torch.equal(e0, e1) and torch.equal(g0, g1)
    assert all(torch.equal(a, b) for k in m0 for a, b in zip(m0[k], m1[k]))
