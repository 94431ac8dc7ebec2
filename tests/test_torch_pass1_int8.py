"""The train step with the W8A8 pass 1 (--pass1_int8) in the port against
the JAX package, at tiny geometry in fp32 on the CPU, and the places the
int8 branch must never reach.

- The SD1.5 step with `pass1_int8`, pass 1 fused (the LoRA-free twin
  quantized) and unfused (`gradient_checkpointing`: the LoRA'd UNet's base
  weights quantized, the LoRA branch beside them in the layer's dtype;
  `remat_min_res` above the resolution keeps JAX's remat compile out), as
  JAX's split step runs it: the presample (pass 1) and then the step
  replaying its tables. The port's step on JAX's int8 tables against JAX's:
  the loss within 1e-3 absolute, every LoRA leaf's gradient and post-step
  value within 1e-3 relative (`torch_step_parity`, JAX's
  `tools/step_loss_fixture.py` TOL / GRAD_TOL), with no int8 layer in it.
  The port's own int8 pass 1 ran every quantized layer STEPS times, and
  moves the eps table from the fp32 one as far as JAX's does.
  Why not the port's own int8 tables against JAX's: each int8 layer
  equals JAX's on the same input (tests/test_torch_quant.py), but the two
  sides' fp32 roundoff elsewhere (~1e-7) puts a rare activation on the
  other side of a code boundary; at this width (K = 32) one such code
  moves a layer by ~3e-3, which flips many codes downstream. Measured
  here: the fused int8 tables of the port and of JAX at cos 0.970 (0.982
  after one call), as far apart as each is from the fp32 table (0.979,
  0.978), and their steps' losses 7.2571 and 7.2363 (fp32: 7.2610 both).
- Two witnesses of that parting, on identical inputs (JAX's contexts,
  latents and step noise fed to both sides). In the first guided call
  every quantized layer's codes equal JAX's jitted pass 1's up to the
  first code that differs; its inputs up to there agree to fp32
  roundoff, and every differing code of that layer sits within roundoff
  of a .5 boundary of the code grid, where an error of the port would
  land anywhere. And JAX's own jitted int8 pass 1, its latents or
  contexts moved by 1 ulp, parts from itself as far as the port parts
  from it.
- The port shares module objects where JAX keeps separate trees: unfused,
  pass 1, the replay and the capture run one UNet, and D shares its base.
  After an int8 pass 1 the replay, the capture forwards, the backward and
  D run no int8 layer, and their outputs equal those before it, bit for bit.
- The trainer CLI takes --pass1_int8 and --prediction_type v_prediction,
  alone and together, fused and under --gradient_checkpointing, SD1.5 and
  SDXL, and runs a step with finite losses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu.diffusion.guidance import make_cfg_eps_model as jax_cfg_eps_model
from comat_tpu.diffusion.sampler import sample_inference as jax_sample_inference
from comat_tpu.diffusion.schedulers import make_sampler_coeffs as jax_sampler_coeffs
from comat_tpu.models import pipeline as jpipe
from comat_tpu.models.quant import QConv, QDense, QDenseGeneral
from comat_tpu_torch.diffusion.sampler import sample_inference
from comat_tpu_torch.diffusion.schedulers import make_sampler_coeffs
from comat_tpu_torch.losses.gan import Discriminator, GanConfig
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.models import quant as tquant
from comat_tpu_torch.ops import quant as oq
from comat_tpu_torch.text.tokenizer import HashTokenizer
from comat_tpu_torch.trace import PhaseClock
from comat_tpu_torch.training import arguments as targs
from comat_tpu_torch.training import train_step as tts
from comat_tpu_torch.training.trainer import Trainer
from comat_tpu_torch.weights import from_jax_params
from torch_step_parity import (
    assert_step_matches, jax_case, port_pipeline, port_step, seeded_params,
)

RES, STEPS, K, RANK = 64, 4, 2, 4
PROMPTS = ["a red car and a blue bird", "two green cats on a mat"]
# the port's W8A8 noise on pass 1's eps table over JAX's, both against the
# fp32 table (1 - cos): 0.95 for the fused pass 1 here (0.0209 and 0.0219)
NOISE_RATIO = (0.75, 1.33)
GUIDANCE = 7.5
# up to the first differing code, the two sides' layer inputs agree to fp32
# roundoff (2e-7 measured), and a code flipped by roundoff sits that close
# to a .5 boundary of the code grid, in code units (1e-6 measured)
ROUNDOFF_REL, BOUNDARY = 1e-5, 1e-3
# 1 - cos of JAX's int8 eps table against itself moved by 1 ulp: at least
# CHAOS_FLOOR (0.0047-0.0111 measured); the port's against JAX's within
# CHAOS_BAND of that range (0.0179 measured)
CHAOS_FLOOR, CHAOS_BAND = 1e-3, 4.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per xdist worker (see tests/test_torch_text_lora.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def int8_calls(monkeypatch):
    """Counts of the int8 layers' calls (linear and conv), as they happen."""
    calls = {"n": 0}
    for name in ("int8_linear", "int8_conv"):
        fn = getattr(tquant, name)

        def counted(*args, _fn=fn, **kw):
            calls["n"] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(tquant, name, counted)
    return calls


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("fused", [True, False])
def test_pass1_int8_step_matches_jax(fused, int8_calls):
    kw = {} if fused else dict(gradient_checkpointing=True, remat_min_res=1024)
    case = jax_case("sd_1_5", RES, STEPS, K, RANK, split=True, pass1_int8=True, **kw)
    pipe, blip, tcfg = port_pipeline(case, "sd_1_5", RANK, fuse_pass1=fused)
    assert tcfg.pass1_int8 and tcfg.gradient_checkpointing == (not fused)
    batch = dict(case["batch"])
    tables = {k: torch.tensor(batch.pop(k)) for k in ("eps_table", "latents_traj")}
    # pass 1 in W8A8 (the presample of the split step) from the step's draws:
    # STEPS guided calls, each through every quantized layer
    _, eps_table, _ = tts.make_presample(pipe, tcfg)(batch, case["draws"])
    n_int8 = STEPS * len(tquant.quantize_unet(pipe.unet))
    assert int8_calls["n"] == n_int8
    _, eps_fp32, _ = tts.make_presample(pipe, dataclasses.replace(tcfg, pass1_int8=False))(
        batch, case["draws"])
    assert int8_calls["n"] == n_int8
    # W8A8 moves the port's eps table from its fp32 one as far as it moves
    # JAX's (1 - cos; the fp32 tables agree to ~1e-10)
    port_noise = 1 - _cos(eps_table, eps_fp32)
    jax_noise = 1 - _cos(tables["eps_table"], eps_fp32)
    assert NOISE_RATIO[0] <= port_noise / jax_noise <= NOISE_RATIO[1], (port_noise, jax_noise)
    # the step replaying JAX's int8 tables, under JAX's gates; no int8 layer runs
    metrics, grads, after, _ = port_step(pipe, blip, tcfg, {**batch, **tables}, case["draws"])
    assert int8_calls["n"] == n_int8
    assert_step_matches(case, metrics, grads, after, must=("unet.",))


@pytest.fixture(scope="module")
def identical_inputs():
    """The fused tiny SD1.5 pass 1 on both sides from one input: JAX's
    pipeline and weights, JAX's contexts of the prompts and the null
    prompts, latents, the first timestep, and the step noise of JAX's
    sampler for `rng`; the port's pipeline on the same weights."""
    jax.config.update("jax_default_matmul_precision", "highest")
    jp = jpipe.DiffusionPipeline(jpipe.make_pipeline_config(
        "sd_1_5", lora_rank=RANK, resolution=RES, tiny=True))
    params = seeded_params(jp.init_params, jax.random.PRNGKey(0), seed=0)
    tok = HashTokenizer(1000)
    enc, null = tok(PROMPTS, max_length=77), tok([""] * len(PROMPTS), max_length=77)
    encode = jax.jit(lambda p, ids, eos: jp.encode_prompt(p, ids, eos).context)
    ctx = np.asarray(encode(params, enc["input_ids"], enc["eos_positions"]))
    nctx = np.asarray(encode(params, null["input_ids"], None))
    h = RES // 8
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (len(PROMPTS), h, h, 4)))
    rng = jax.random.PRNGKey(9)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng, i), lat.shape))
                      for i in range(STEPS)])
    coeffs = jax_sampler_coeffs(jp.schedule, STEPS, kind="ddpm")
    pipe = tpipe.DiffusionPipeline(
        tpipe.make_pipeline_config("sd_1_5", lora_rank=RANK, resolution=RES, tiny=True),
        device="cpu", params=from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return dict(jp=jp, params=params, ctx=ctx, nctx=nctx, lat=lat, rng=rng, noise=noise,
                coeffs=coeffs, t=int(coeffs.timesteps[0]), pipe=pipe)


def _jax_eps_model(case, params, ctx, nctx):
    """JAX's pass-1 guided eps model, as its presample builds it (fused,
    int8)."""
    jp = case["jp"]
    pf = jp.fused_params(params, int8=True)
    return jax_cfg_eps_model(
        lambda lat, t, c, ac, cap: jp.unet_apply(pf, lat, t, c, ac, cap, fast=True, fused=True),
        ctx, nctx, GUIDANCE, 0.0, None, None)


def _port_pass1(case, first_call_only=False):
    """The port's fused int8 pass 1 on the case's inputs: the eps table, or
    the first guided call's eps."""
    pipe = case["pipe"]
    unet = pipe._pass1_unet()
    em = pipe._pass1_eps_model(torch.tensor(case["ctx"]), torch.tensor(case["nctx"]),
                               GUIDANCE, 0.0, unet)
    with torch.no_grad(), tquant.pass1_w8a8(unet, True):
        if first_call_only:
            return em(torch.tensor(case["lat"]), case["t"]).numpy()
        _, table, _ = sample_inference(
            em, make_sampler_coeffs(pipe.schedule, STEPS, kind="ddpm"),
            torch.tensor(case["lat"]), step_noise=torch.tensor(case["noise"]))
    return table.numpy()


def test_first_guided_call_parts_from_jax_only_at_a_code_boundary(identical_inputs,
                                                                   monkeypatch):
    case = identical_inputs

    @jax.jit
    def jax_call(params, ctx, nctx, lat):
        import flax.linen as nn

        seen = []

        def record(next_fun, args, kwargs, context):
            if (isinstance(context.module, (QDense, QDenseGeneral, QConv))
                    and context.method_name == "__call__"):
                seen.append(args[0])
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(record):
            eps, _ = _jax_eps_model(case, params, ctx, nctx)(lat, jnp.asarray(case["t"]))
        return eps, seen

    want, seen = jax.tree_util.tree_map(np.asarray, jax_call(
        case["params"], case["ctx"], case["nctx"], case["lat"]))
    acts = []       # the port's activation quantizes, in call order: (x, codes, scales)
    quantize = oq.quantize

    def recording(x, groups, role="act"):
        q, sc = quantize(x, groups, role)
        if role == "act":
            acts.append((x.clone(), q, sc))
        return q, sc

    monkeypatch.setattr(oq, "quantize", recording)
    got = _port_pass1(case, first_call_only=True)
    n_layers = len(tquant.quantize_unet(case["pipe"].fused_unet()))
    assert len(acts) == len(seen) == n_layers       # one guided call: one UNet call
    for i, (xj, (x, q, sc)) in enumerate(zip(seen, acts)):
        xj = torch.tensor(xj).reshape(x.shape)
        qj, sj = oq.quantize_ref(xj, sc.numel())
        assert float((x - xj).abs().max() / xj.abs().max()) <= ROUNDOFF_REL, i
        if torch.equal(q, qj):
            continue
        # the first layer whose codes differ: each differing code is one
        # whose JAX value lies at a .5 boundary, within roundoff
        r = xj.double().reshape(sc.numel(), -1).abs() / sj.double()[:, None]
        off = (r - r.floor() - 0.5).abs()[(q != qj).reshape(r.shape)]
        assert float(off.max()) <= BOUNDARY, (i, off.tolist()[:8])
        break
    else:
        # no code differs: the guided eps is JAX's to roundoff
        assert np.abs(got - want).max() <= ROUNDOFF_REL * np.abs(want).max()


def test_int8_pass1_parts_from_jax_as_far_as_jax_from_itself(identical_inputs):
    case = identical_inputs

    @jax.jit
    def jax_pass1(params, ctx, nctx, lat):
        em = _jax_eps_model(case, params, ctx, nctx)
        return jax_sample_inference(em, case["coeffs"], lat, case["rng"])[1]

    ctx, nctx, lat = case["ctx"], case["nctx"], case["lat"]
    want = np.asarray(jax_pass1(case["params"], ctx, nctx, lat))
    up, down = np.float32(np.inf), np.float32(-np.inf)
    moved = [(ctx, nctx, np.nextafter(lat, up)), (ctx, nctx, np.nextafter(lat, down)),
             (np.nextafter(ctx, up), nctx, lat), (np.nextafter(ctx, down), nctx, lat)]
    itself = [1 - _cos(jax_pass1(case["params"], *m), want) for m in moved]
    port = 1 - _cos(_port_pass1(case), want)
    assert min(itself) >= CHAOS_FLOOR, itself
    assert min(itself) / CHAOS_BAND <= port <= CHAOS_BAND * max(itself), (port, itself)


def _tiny_setup(res=128):
    cfg = tpipe.make_pipeline_config("sd_1_5_attrcon", lora_rank=RANK, resolution=res,
                                     tiny=True)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu", fuse_pass1=False)
    disc = Discriminator(cfg.unet, GanConfig(lora_rank=RANK), device="cpu",
                         base_unet=pipe.unet)
    tts.partition_params(pipe)
    g = torch.Generator().manual_seed(3)
    for n, p in pipe.unet.named_parameters():
        if n.endswith("lora_b"):
            with torch.no_grad():
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    tok = HashTokenizer(1000)
    enc, null = tok(PROMPTS[:1], max_length=77), tok([""], max_length=77)
    s = cfg.latent_size
    lat = torch.randn(1, s, s, 4, generator=g)
    noise = torch.randn(STEPS, 1, s, s, 4, generator=g)
    return pipe, disc, enc, null, lat, noise


def test_replay_capture_and_d_never_run_int8(int8_calls):
    pipe, disc, enc, null, lat, noise = _tiny_setup()
    ctx = pipe.encode_prompt(enc["input_ids"], enc["eos_positions"]).context
    t = 501

    def outputs():
        with torch.no_grad():
            return (pipe.unet_apply(lat, t, ctx),
                    pipe.unet_apply(lat, t, ctx, capture=True)[1],
                    disc.logits(lat, t, ctx))

    before = outputs()
    assert int8_calls["n"] == 0
    # each mark of the forward and its backward reads the int8 calls so far
    clock = PhaseClock(torch.device("cpu"), probe=lambda: dict(int8_calls))
    with clock.active():
        image, result = pipe.forward(
            enc["input_ids"], null["input_ids"], [0, 2], num_inference_steps=STEPS, K=2,
            eos_positions=enc["eos_positions"], latents0=lat, step_noise=noise,
            capture=True, capture_idx=[1], remat=True, pass1_int8=True)
        pass1 = clock.marks["pass1"][-1][1]["n"]
        assert pass1 == STEPS * len(tquant.quantize_unet(pipe.unet))
        maps = [m for v in result.captured.values() for m in v]
        assert maps
        loss = image.mean() + sum(m.float().mean() for m in maps)
        loss = loss + disc.logits(result.latents, t, ctx).mean()
        loss.backward()
    # after pass 1 (whose guided calls mark "unet>"), no int8 call
    marks = [(name, reading["n"]) for name, entries in clock.marks.items()
             if name != "unet>" for _, reading, _ in entries]
    assert {"pass1", "replay", "pass2", "replay_bwd>", "capture_bwd>"} <= dict(marks).keys()
    assert all(n == pass1 for _, n in marks), marks
    assert int8_calls["n"] == pass1
    grads = [p.grad for p in pipe.unet.parameters() if p.requires_grad]
    assert grads and all(g is not None and torch.isfinite(g).all() for g in grads)
    # the presample (the split step's pass 1) leaves the modules plain too
    pipe.presample(enc["input_ids"], null["input_ids"], num_inference_steps=STEPS,
                   eos_positions=enc["eos_positions"], latents0=lat, step_noise=noise,
                   pass1_int8=True)
    assert all(m.w8a8 is None for m in pipe.unet.modules()
               if isinstance(m, (tquant.QLinear, tquant.QConv2d)))
    after = outputs()
    assert torch.equal(before[0], after[0]) and torch.equal(before[2], after[2])
    assert before[1].keys() == after[1].keys()
    assert all(torch.equal(a, b) for k in before[1] for a, b in zip(before[1][k], after[1][k]))


@pytest.mark.parametrize("flags", [
    ["--pass1_int8"], ["--prediction_type", "v_prediction"],
    ["--pass1_int8", "--prediction_type", "v_prediction", "--gradient_checkpointing"],
    ["--pretrain_model_name", "sdxl", "--pass1_int8", "--prediction_type", "v_prediction"]])
def test_trainer_takes_int8_and_v_prediction(tmp_path, flags):
    (tmp_path / "p.txt").write_text("\n".join(PROMPTS))
    args = targs.parse_args([
        "--training_prompts", str(tmp_path / "p.txt"), "--output_dir", str(tmp_path / "out"),
        "--device", "cpu", "--pretrain_model_name", "sd_1_5", "--tiny_models",
        "--resolution", "64", "--lora_rank", "4", "--train_batch_size", "2",
        "--total_step", "4", "--K", "2", "--allow_smoke", "--report_to", "none", *flags])
    trainer = Trainer(args)
    assert trainer.tcfg.pass1_int8 == ("--pass1_int8" in flags)
    want = "v_prediction" if "v_prediction" in flags else "epsilon"
    assert trainer.pcfg.prediction_type == want
    assert trainer.pcfg.is_sdxl == ("sdxl" in flags)
    m = trainer.train_one(PROMPTS)
    assert np.isfinite(m["step_loss"]) and np.isfinite(m["grad_norm"])
