"""fp32 master weights of a trained bf16 tower (`tune_vae`,
`tune_text_encoder`) in the port's train step
(comat_tpu_torch/training/train_step.py `ClippedAdamW`) against JAX, which
trains fp32 Flax parameters under bf16 modules.

The JAX run: `jax.value_and_grad(make_loss_fn(...))` on fp32 parameters
with the VAE and the CLIP text encoder computing in bf16
(`VAEConfig(dtype=bf16)`, `CLIPTextConfig(dtype=bf16)`),
`partition_params(tune_vae=True, tune_text_encoder=True)`,
`train_text_encoder`, a `textenc_lr` group, then one optax update
(clip_by_global_norm + adamw). The port builds the same pipeline in bf16
from the same fp32 weights, with those weights as the initial masters, and
takes one `make_train_step` step on the same injected draws. Tiny
geometry, 64^2, total_step 4, K 2, batch 2, LoRA rank 4 with nonzero
`lora_b`.

Tolerances (measured distances in the test docstrings). bf16 rounds at
other points in the two frameworks: JAX's GroupNorm and LayerNorm apply
their fp32 scale and bias before the bf16 cast, the port's bf16 modules
use rounded ones; products and convolutions round their bf16 outputs
after sums taken in another order; the text encoder's two uses a step
(prompts, null prompts) add their bf16 cotangents in bf16 in the port, in
fp32 in JAX. Each side's bf16 gradient is 2-4 % (L2 over the tower) from
the fp32 one, so a tower gradient leaf is held to GRAD_TOL relative, and
the towers as a whole to "no further from fp32 than JAX's bf16 gradient,
within NOISE_RATIO". The optimizer itself is held exactly: the new
masters are optax's step from JAX's fp32 leaves with the port's own
gradients (1e-6 relative). Against JAX's new leaves a master can differ
by up to 2 lr, where the bf16 rounding flips the sign of a near-zero
gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from comat_tpu.config import BLIPConfig as JBLIPConfig
from comat_tpu.losses.caption_reward import build_caption_batch
from comat_tpu.models import pipeline as jpipe
from comat_tpu.models.blip import BLIPCaptioner as JBLIP
from comat_tpu.text.tokenizer import HashTokenizer
from comat_tpu.training import train_step as jts
from comat_tpu_torch.config import BLIPConfig
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.models.blip import BLIPCaptioner
from comat_tpu_torch.training import train_step as tts
from comat_tpu_torch.weights import from_jax_params

PROMPTS = ["a red car and a blue bird", "two green cats on a mat"]
RES, STEPS, K, RANK = 64, 4, 2, 4
LR, TEXT_LR = 5e-5, 1e-4
GRAD_TOL = 0.15
ZERO_LEAF_REL, ZERO_LEAF_TOL = 1e-6, 2e-3
NOISE_RATIO = 1.5
LOSS_TOL = 1e-2
TOWERS = {"vae": "tune_vae", "text": "tune_text_encoder"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run in parallel worker processes (pytest-xdist);
    one intra-op thread per worker keeps their torch work from
    oversubscribing the cores, which slows every worker many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16_towers(cfg, bf16):
    return dataclasses.replace(
        cfg, vae=dataclasses.replace(cfg.vae, dtype=bf16),
        text=dataclasses.replace(cfg.text, dtype=bf16))


def _by_port_name(tree):
    """A JAX tree with vae / text subtrees -> {"vae.<name>", "text.<name>"}
    numpy arrays under the port's names and layouts."""
    flat = {
        tuple(str(getattr(k, "key", k)) for k in path): np.asarray(leaf, np.float32)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }
    nested = {}
    for path, leaf in flat.items():
        if path[0] not in TOWERS:
            continue
        node = nested.setdefault(path[0], {})
        for k in path[1:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return {f"{tower}.{n}": t.numpy() for tower, sd in from_jax_params(nested).items()
            for n, t in sd.items()}


def _nonzero_lora_b(params, seed=3):
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        if getattr(path[-1], "key", None) == "lora_b":
            return jnp.asarray(0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(f, params)


@pytest.fixture(scope="module")
def case():
    jax.config.update("jax_default_matmul_precision", "highest")
    pcfg = _bf16_towers(jpipe.make_pipeline_config(
        "sd_1_5", lora_rank=RANK, resolution=RES, tiny=True), jnp.bfloat16)
    pipe = jpipe.DiffusionPipeline(pcfg)
    params = _nonzero_lora_b(pipe.init_params(jax.random.PRNGKey(0)))
    tok = HashTokenizer(1000)
    enc = tok(PROMPTS, max_length=77)
    null = tok([""] * len(PROMPTS), max_length=77)
    cap = build_caption_batch(tok, PROMPTS)
    batch = {
        "input_ids": enc["input_ids"], "eos_positions": enc["eos_positions"],
        "null_ids": null["input_ids"], "caption_ids": cap["input_ids"],
        "caption_mask": cap["attention_mask"], "caption_labels": cap["labels"],
    }
    blip = JBLIP(JBLIPConfig.tiny())
    blip_params = blip.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)),
        jnp.asarray(cap["input_ids"][:1]), jnp.asarray(cap["attention_mask"][:1]),
        jnp.asarray(cap["labels"][:1]),
    )
    jcfg = jts.TrainConfig(total_step=STEPS, K=K, resolution=RES, learning_rate=LR,
                           textenc_lr=TEXT_LR, train_text_encoder=True)

    rng0 = jax.random.fold_in(jax.random.PRNGKey(5), 0)
    rngs = jax.random.split(rng0, 4)
    trained_idx = np.asarray(jts.sample_trained_idx(rngs[0], jcfg))
    rng_noise, lrng = jax.random.split(rngs[1])
    h = RES // 8
    latents0 = np.asarray(jax.random.normal(lrng, (len(PROMPTS), h, h, 4)))
    noise = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(rng_noise, i),
                                     (len(PROMPTS), h, h, 4)))
        for i in range(STEPS)
    ])
    offset_range = RES // 224
    crop = tuple(int(jax.random.randint(r, (), 0, offset_range + 1))
                 for r in rngs[2:])

    trainable, frozen = jts.partition_params(params, tune_vae=True,
                                             tune_text_encoder=True)
    loss_fn = jts.make_loss_fn(pipe, blip, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        trainable, frozen, blip_params, jbatch, rng0, None)
    opt = jts.make_optimizer(jcfg)
    updates, _ = opt.update(grads, opt.init(trainable), trainable)
    new = optax.apply_updates(trainable, updates)

    weights = from_jax_params(jax.tree_util.tree_map(
        np.asarray, {**params, "blip": blip_params}))
    draws = tts.StepDraws(torch.tensor(latents0), torch.tensor(noise),
                          int(trained_idx[0]), crop)
    return dict(batch=batch, weights=weights, draws=draws, jcfg=jcfg,
                loss=float(loss), grads=_by_port_name(grads),
                before=_by_port_name(trainable), after=_by_port_name(new),
                grad_norm=float(optax.global_norm(grads)))


def _port(case, dtype):
    cfg = _bf16_towers(tpipe.make_pipeline_config(
        "sd_1_5", lora_rank=RANK, resolution=RES, tiny=True), dtype)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu", params=case["weights"])
    blip = BLIPCaptioner(BLIPConfig.tiny()).requires_grad_(False)
    blip.load_state_dict(case["weights"]["blip"])
    tcfg = tts.TrainConfig(**{f.name: getattr(case["jcfg"], f.name)
                              for f in dataclasses.fields(tts.TrainConfig)})
    return pipe, blip, tcfg


@pytest.fixture(scope="module")
def fp32_grads(case):
    """The towers' gradients of one port loss and backward with fp32
    towers (the port's fp32 step matches JAX's, tests/test_torch_train_step.py)."""
    pipe, blip, tcfg = _port(case, torch.float32)
    trainable = tts.partition_params(pipe, tune_vae=True, tune_text_encoder=True)
    loss, _ = tts.make_loss_fn(pipe, blip, tcfg)(case["batch"], case["draws"])
    loss.backward()
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
            .astype(np.float64)
            for n, p in trainable.items() if n.split(".")[0] in TOWERS}


@pytest.fixture(scope="module")
def port_step(case):
    """One port step from the same weights in bf16, with those weights as
    the initial masters: the masters before, the step's gradients as the
    backward left them on the masters (a bf16 tensor's lands on its fp32
    master; captured before the clip, which scales them in place), the
    state after, the metrics. The VAE encoder, which the step does not
    run, gets no gradient; it is taken as zero, as the optimizer takes
    it."""
    pipe, blip, tcfg = _port(case, torch.bfloat16)
    masters = {f"{tower}.{n}": t for tower in TOWERS
               for n, t in case["weights"][tower].items()}
    state = tts.init_train_state(pipe, tcfg, tune_vae=True, tune_text_encoder=True,
                                 initial_masters=masters)
    before = {n: m.detach().clone() for n, m in state.optimizer.masters.items()}
    grads = {}
    hooks = [state.optimizer.masters[n].register_post_accumulate_grad_hook(
        lambda t, n=n: grads.__setitem__(n, t.grad.detach().float().clone()))
        for n in state.trainable]
    state, metrics = tts.make_train_step(pipe, blip, tcfg)(
        state, case["batch"], case["draws"])
    for h in hooks:
        h.remove()
    unreached = [n for n in state.trainable if n not in grads]
    assert unreached and all(n.startswith(("vae.encoder.", "vae.quant_conv."))
                             for n in unreached)
    for n in unreached:
        grads[n] = torch.zeros_like(state.optimizer.masters[n]).detach()
    return dict(state=state, metrics=metrics, before=before, grads=grads)


def _tower(names, tower):
    return sorted(n for n in names if n.startswith(tower + "."))


def _bf16_grads(port_step):
    """The towers' gradients of the port step: their bf16 working copies'."""
    return {n: g.numpy().astype(np.float64) for n, g in port_step["grads"].items()
            if n.split(".")[0] in TOWERS}


@pytest.mark.parametrize("tower", list(TOWERS))
def test_masters_start_from_the_fp32_weights(case, port_step, tower):
    """The masters are the fp32 values the bf16 weights were rounded from,
    not the rounded copies; an fp32 tensor (VAE conv_out) is its own."""
    before, masters = port_step["before"], port_step["state"].optimizer.masters
    names = _tower(masters, tower)
    assert names and set(names) == set(_tower(case["before"], tower))
    for n in names:
        assert masters[n].dtype == torch.float32
        np.testing.assert_array_equal(before[n].numpy(), case["before"][n])
    # the random weights (not the zero biases, unit norm scales) lose bits
    weights = [n for n in names if before[n].dim() >= 2]
    assert weights and all(
        not torch.equal(before[n], before[n].bfloat16().float()) for n in weights)
    if tower == "vae":
        p = port_step["state"].trainable["vae.decoder.conv_out.weight"]
        assert p.dtype == torch.float32
        assert masters["vae.decoder.conv_out.weight"] is p


@pytest.mark.parametrize("tower", list(TOWERS))
def test_tower_gradients_match_jax(case, port_step, fp32_grads, tower):
    """The bf16 working copies' gradients against JAX's fp32-leaf
    gradients, each leaf within GRAD_TOL relative. Measured worst: VAE
    6.7e-2 (an up-block conv bias, whose sum over pixels cancels), text
    9.4e-2 (a value-projection bias); JAX's own bf16 gradients are up to
    7.3e-2 from the fp32 gradient at those leaves. A leaf whose fp32
    gradient stays below ZERO_LEAF_REL of the tower's largest (the key
    biases: a softmax cancels q.b) is rounding noise on both sides and is
    held to ZERO_LEAF_TOL of the largest gradient instead (measured
    1.0e-3). A leaf no gradient reaches (the VAE encoder, which the step
    does not run) is zero on all three sides, exactly."""
    grads, want, g32 = _bf16_grads(port_step), case["grads"], fp32_grads
    names = _tower(grads, tower)
    assert names and set(names) == set(_tower(want, tower))
    unreached = [n for n in names if not g32[n].any() and not want[n].any()]
    assert all(not grads[n].any() for n in unreached)
    assert (len(unreached) > 0) == (tower == "vae")
    names = [n for n in names if n not in unreached]
    scale = max(np.abs(want[n]).max() for n in names)
    rel, zero = {}, {}
    for n in names:
        err = np.abs(grads[n] - want[n]).max()
        if np.abs(g32[n]).max() < ZERO_LEAF_REL * scale:
            zero[n] = err / scale
        else:
            rel[n] = err / np.abs(want[n]).max()
    worst = max(rel, key=rel.get)
    print(f"{tower}: worst leaf {worst} {rel[worst]:.3e}; zero leaves {zero}")
    assert rel[worst] <= GRAD_TOL, (worst, rel[worst])
    assert len(zero) <= 3 and all(e <= ZERO_LEAF_TOL for e in zero.values()), zero


@pytest.mark.parametrize("tower", list(TOWERS))
def test_tower_gradients_are_bf16_noise_about_fp32(case, port_step, fp32_grads, tower):
    """Over the tower, the port's bf16 gradient is no further from the
    fp32 gradient (the port's fp32 towers, which match JAX's in fp32) than
    JAX's bf16 gradient is, within NOISE_RATIO, and the two bf16
    gradients are no further apart than that. Measured, as fractions of
    the fp32 gradient's norm: VAE port 1.86e-2, JAX 2.17e-2, port-JAX
    1.62e-2; text 4.08e-2, 3.86e-2, 3.85e-2."""
    grads, want, g32 = _bf16_grads(port_step), case["grads"], fp32_grads
    names = _tower(grads, tower)
    flat = lambda d: np.concatenate([d[n].ravel() for n in names])  # noqa: E731
    ref = flat(g32)
    dist = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(ref)  # noqa: E731
    port, jax_, apart = dist(flat(grads), ref), dist(flat(want), ref), dist(flat(grads), flat(want))
    print(f"{tower}: port {port:.3e}, JAX {jax_:.3e}, port-JAX {apart:.3e}")
    assert 0 < port <= NOISE_RATIO * jax_ and apart <= NOISE_RATIO * jax_


@pytest.mark.parametrize("tower", list(TOWERS))
def test_masters_take_optax_steps_from_the_fp32_weights(case, port_step, tower):
    """The new masters are JAX's optimizer (`make_optimizer`: the joint
    clip, AdamW, the `textenc_lr` group) applied to JAX's fp32 leaves with
    the port step's own gradients, bf16 ones cast to fp32: the same fp32
    update in another order (a few fp32 steps at the weights' scale)."""
    masters, grads = port_step["state"].optimizer.masters, port_step["grads"]
    params = {n: case["before"].get(n, port_step["before"][n].numpy()) for n in masters}
    nest = lambda d: {t: {n: jnp.asarray(v) for n, v in d.items()  # noqa: E731
                          if n.startswith(t + ".")} for t in ("unet", *TOWERS)}
    opt = jts.make_optimizer(case["jcfg"])
    jparams = nest(params)
    updates, _ = opt.update(nest({n: g.numpy() for n, g in grads.items()}),
                            opt.init(jparams), jparams)
    want = optax.apply_updates(jparams, updates)
    for n in _tower(masters, tower):
        np.testing.assert_allclose(masters[n].detach().numpy(),
                                   np.asarray(want[tower][n]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("tower", list(TOWERS))
def test_tower_masters_after_a_step_match_jax(case, port_step, tower):
    """The new fp32 masters against JAX's new fp32 leaves (the text tower
    at its own `textenc_lr`): within 2 lr everywhere, a sign of the
    clipped gradient that bf16 rounding flips. Measured: the VAE's within
    1e-3 lr on 88 % of the elements, the text tower's on 98 %: after the
    clip most gradients lie near AdamW's eps, where the step still
    follows their size."""
    masters = port_step["state"].optimizer.masters
    lr = TEXT_LR if tower == "text" else LR
    names = _tower(masters, tower)
    err = np.concatenate([
        (masters[n].detach().numpy().astype(np.float64) - case["after"][n]).ravel()
        for n in names])
    step = np.concatenate([
        (masters[n].detach().numpy().astype(np.float64) - case["before"][n]).ravel()
        for n in names])
    share = float((np.abs(err) <= 1e-3 * lr).mean())
    print(f"{tower}: max |master - JAX| {np.abs(err).max() / lr:.3f} lr, within "
          f"1e-3 lr: {share:.5f}")
    assert np.abs(step).max() > 0.5 * lr
    assert np.abs(err).max() <= 2 * lr * 1.01, np.abs(err).max()


def test_step_metrics_match_jax(case, port_step):
    """The loss (bf16 towers: measured 0.0 apart) and the gradient norm
    (measured 0.0 relative) of the step."""
    m = port_step["metrics"]
    print(f"loss {m['step_loss']} vs {case['loss']}, grad_norm {m['grad_norm']} vs "
          f"{case['grad_norm']}")
    assert abs(m["step_loss"] - case["loss"]) <= LOSS_TOL
    assert abs(m["grad_norm"] - case["grad_norm"]) <= GRAD_TOL * case["grad_norm"]


def test_working_copies_are_the_rounded_masters(port_step):
    state = port_step["state"]
    bf16 = [n for n, p in state.trainable.items() if p.dtype == torch.bfloat16]
    assert {n.split(".")[0] for n in bf16} == set(TOWERS)
    for n in bf16:
        master = state.optimizer.masters[n]
        assert master is not state.trainable[n]
        assert torch.equal(state.trainable[n].detach(), master.bfloat16())
        # a zero tensor without gradient (an encoder bias) stays zero
        still = not port_step["grads"][n].any() and not master.any()
        assert still or not torch.equal(master, port_step["before"][n]), n


def _optax_update(cfg, params, grads, steps):
    opt = optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adamw(cfg.learning_rate, b1=cfg.adam_b1, b2=cfg.adam_b2,
                    eps=cfg.adam_eps, weight_decay=cfg.adam_weight_decay),
    )
    params = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(params)
    for g in grads[:steps]:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("scale", [0.01, 10.0])
@pytest.mark.parametrize("tower", list(TOWERS))
def test_masters_and_clipped_adamw_match_optax(tower, scale):
    """Three steps on given bf16 gradients: bf16 working copies with fp32
    masters (one of them given, one upcast) beside an fp32 tensor, under
    and over the clip norm, against optax on the fp32 parameters with the
    same gradients in fp32; after each step every working copy is its
    master rounded to bf16. optax takes AdamW's bias corrections 1 - b^t
    in fp32 (1 - 0.999 is 1.3e-5 off), torch in fp64, so steps of lr 1e-2
    differ by up to ~1e-7 each: 1e-6 absolute over three, measured 2.0e-7
    (an element that crosses zero, where the relative bound does not
    reach)."""
    rng = np.random.default_rng(1)
    shapes = {"unet.lora_a": (6, 4), f"{tower}.w": (8, 5), f"{tower}.b": (7,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    for g in grads:         # the working copies' gradients are bf16
        for k in (f"{tower}.w", f"{tower}.b"):
            g[k] = torch.from_numpy(g[k]).bfloat16().float().numpy()
    tensors = {
        k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(
            torch.float32 if k.startswith("unet.") else torch.bfloat16))
        for k, v in params.items()}
    # the bias's master is its bf16 copy upcast, not the fp32 value
    params[f"{tower}.b"] = tensors[f"{tower}.b"].detach().float().numpy()
    cfg = tts.TrainConfig(learning_rate=1e-2)
    opt = tts.make_optimizer(cfg, tensors, {f"{tower}.w": torch.from_numpy(params[f"{tower}.w"])})
    assert opt.masters["unet.lora_a"] is tensors["unet.lora_a"]
    for g in grads:
        opt.zero_grad()
        for k, p in tensors.items():
            p.grad = torch.from_numpy(g[k].copy()).to(p.dtype)
        opt.step()
        for k, p in tensors.items():
            assert torch.equal(p.detach(), opt.masters[k].to(p.dtype))
    want = _optax_update(cfg, params, grads, steps=3)
    for k, m in opt.masters.items():
        assert m.dtype == torch.float32
        np.testing.assert_allclose(m.detach().numpy(), want[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tower", list(TOWERS))
def test_partition_params_trains_a_bf16_tower(tower):
    """Either flag alone on a bf16 tower: its tensors train in bf16, each
    with an fp32 master equal to it upcast (no initial masters given);
    the other towers stay frozen but for the LoRA factors."""
    cfg = tpipe.make_pipeline_config("sd_1_5", lora_rank=RANK, resolution=RES,
                                     tiny=True)
    cfg = dataclasses.replace(cfg, **{tower: dataclasses.replace(
        getattr(cfg, tower), dtype=torch.bfloat16)})
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu")
    state = tts.init_train_state(pipe, tts.TrainConfig(), **{TOWERS[tower]: True})
    module = {"vae": pipe.vae, "text": pipe.text}[tower]
    names = _tower(state.trainable, tower)
    assert len(names) == len(list(module.parameters()))
    assert all(n.startswith((tower + ".", "unet.")) for n in state.trainable)
    assert all("lora_" in n for n in state.trainable if n.startswith("unet."))
    for n in names:
        p, m = state.trainable[n], state.optimizer.masters[n]
        assert p.requires_grad and m.dtype == torch.float32
        assert (m is p) == (p.dtype == torch.float32)
        assert torch.equal(m, p.detach().float())
