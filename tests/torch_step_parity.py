"""Shared set-up of the port's whole-step parity tests against the JAX
package at tiny geometry in fp32 on the CPU (tests/test_torch_text_lora.py,
test_torch_full_finetune.py, test_torch_sdxl_tune_text.py): one jitted JAX
`value_and_grad(make_loss_fn(...))` on a parameter tree filled from numpy
through `jax.eval_shape`, then optax's update of the trainable leaves;
the port's `make_train_step` on the same weights and injected draws.

The gates are the JAX package's whole-step gates
(`tools/step_loss_fixture.py` TOL and GRAD_TOL): the loss within 1e-3
absolute; each trainable leaf's gradient and post-step value within 1e-3
relative (max |delta| over the larger max |value| of the two sides).
A leaf that starts at zero (a norm or linear bias) is its first AdamW
update after the step, lr * g / (|g| + eps) elementwise: there the
gradient's elements far below the leaf's largest, which the gradient
gate leaves free, set the value. Such a leaf is held to its update from
the port's own gradient (1e-6 relative: the optimizer's arithmetic) and,
on the elements where the gradient gate fixes the update to 1e-3
(|g| (|g| + eps) >= eps max |g|, g JAX's clipped gradient), to JAX's
post-step value within 1e-3 relative. A leaf whose gradient is zero in
exact arithmetic (a key projection's bias: softmax ignores a shift
shared by all keys) holds rounding noise on both sides: a leaf whose JAX
gradient is below ZERO_LEAF of the largest over all leaves is held to
GRAD_TOL of that largest, absolutely, and its post-step value, noise
through AdamW, to the port's own update only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
LOSS_TOL, GRAD_TOL = 1e-3, 1e-3
ZERO_LEAF = 1e-6
TOWERS = ("unet", "text", "text2", "vae")


def seeded_params(init, *args, seed=0):
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


def _flat(tree):
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nested(flat):
    out = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def by_port_name(tree):
    """A JAX tree of {unet, text, text2, vae} subtrees (None leaves
    dropped) -> {"<tower>.<name>": numpy} under the port's names."""
    nested = {}
    for path, leaf in _flat(tree).items():
        nested.setdefault(path[0], {})[path[1:]] = leaf
    sds = from_jax_params({t: _nested(f) for t, f in nested.items() if t in TOWERS})
    return {f"{t}.{n}": v.numpy() for t, sd in sds.items() for n, v in sd.items()}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    denom = max(np.abs(got).max(), np.abs(want).max(), 1e-12)
    return float(np.abs(got - want).max() / denom)


def jax_case(name, res, steps, K, rank, text_lora_rank=0, edit_cfg=None,
             partition=None, split=False, **train_kw):
    """JAX's loss, gradients and post-step trainable leaves for one step of
    `name`'s tiny pipeline (`edit_cfg(pcfg)` edits its config), the
    trainable surface `partition` (`jts.partition_params` keywords) and
    `jts.TrainConfig(**train_kw)`; with the port's weights, batch and draws.
    `split`: JAX's split step, its presample program (pass 1, as the
    trainer runs it for Grounded-SAM) and then the step replaying pass 1's
    tables, which the case's batch then holds (`eps_table`,
    `latents_traj`, numpy)."""
    jax.config.update("jax_default_matmul_precision", "highest")
    pcfg = jpipe.make_pipeline_config(name, lora_rank=rank, text_lora_rank=text_lora_rank,
                                      resolution=res, tiny=True)
    if edit_cfg is not None:
        pcfg = edit_cfg(pcfg)
    pipe = jpipe.DiffusionPipeline(pcfg)
    params = seeded_params(pipe.init_params, jax.random.PRNGKey(0), seed=0)
    tok = HashTokenizer(1000)
    B = len(PROMPTS)
    enc, null = tok(PROMPTS, max_length=77), tok([""] * B, max_length=77)
    cap = build_caption_batch(tok, PROMPTS)
    batch = {
        "input_ids": enc["input_ids"], "eos_positions": enc["eos_positions"],
        "null_ids": null["input_ids"], "caption_ids": cap["input_ids"],
        "caption_mask": cap["attention_mask"], "caption_labels": cap["labels"],
    }
    if pcfg.is_sdxl:
        tok2 = HashTokenizer(1000, pad_token_id=0)
        batch["input_ids2"] = tok2(PROMPTS, max_length=77)["input_ids"]
        batch["null_ids2"] = tok2([""] * B, max_length=77)["input_ids"]
    blip = JBLIP(JBLIPConfig.tiny())
    blip_params = seeded_params(
        blip.init, jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3)),
        jnp.asarray(cap["input_ids"][:1]), jnp.asarray(cap["attention_mask"][:1]),
        jnp.asarray(cap["labels"][:1]), seed=1)
    jcfg = jts.TrainConfig(total_step=steps, K=K, resolution=res, **train_kw)

    # the draws of the JAX step at state.step == 0, as run_fixture makes them
    rng0 = jax.random.fold_in(jax.random.PRNGKey(5), 0)
    rngs = jax.random.split(rng0, 4)
    trained_idx = np.asarray(jts.sample_trained_idx(rngs[0], jcfg))
    rng_noise, lrng = jax.random.split(rngs[1])
    h = res // 8
    latents0 = np.asarray(jax.random.normal(lrng, (B, h, h, 4)))
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng_noise, i),
                                                   (B, h, h, 4))) for i in range(steps)])
    crop = tuple(int(jax.random.randint(r, (), 0, res // 224 + 1)) for r in rngs[2:])

    trainable, frozen = jts.partition_params(params, **(partition or {}))
    loss_fn = jts.make_loss_fn(pipe, blip, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if split:
        state0 = jts.TrainState(jnp.zeros((), jnp.int32), trainable, None)
        _, eps_table, traj = jax.jit(jts.make_presample(pipe, jcfg))(
            state0, frozen, jbatch, jax.random.PRNGKey(5))
        jbatch.update(eps_table=eps_table, latents_traj=traj)
        batch.update(eps_table=np.asarray(eps_table), latents_traj=np.asarray(traj))
    (loss, (metrics, _)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        trainable, frozen, blip_params, jbatch, rng0, None)
    opt = jts.make_optimizer(jcfg)
    updates, _ = opt.update(grads, opt.init(trainable), trainable)
    new = optax.apply_updates(trainable, updates)
    weights = from_jax_params(jax.tree_util.tree_map(
        np.asarray, {**params, "blip": blip_params}))
    draws = tts.StepDraws(torch.tensor(latents0), torch.tensor(noise),
                          int(trained_idx[0]), crop)
    return dict(batch=batch, weights=weights, draws=draws, jcfg=jcfg, pcfg=pcfg,
                loss=float(loss), metrics={k: float(v) for k, v in metrics.items()},
                grads=by_port_name(grads), before=by_port_name(trainable),
                after=by_port_name(new))


def port_pipeline(case, name, rank, text_lora_rank=0, edit_cfg=None, **pipe_kw):
    cfg = tpipe.make_pipeline_config(name, lora_rank=rank, text_lora_rank=text_lora_rank,
                                     resolution=case["jcfg"].resolution, tiny=True)
    if edit_cfg is not None:
        cfg = edit_cfg(cfg)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu", params=case["weights"], **pipe_kw)
    blip = BLIPCaptioner(BLIPConfig.tiny()).requires_grad_(False)
    blip.load_state_dict(case["weights"]["blip"])
    tcfg = tts.TrainConfig(**{f.name: getattr(case["jcfg"], f.name)
                              for f in dataclasses.fields(tts.TrainConfig)})
    return pipe, blip, tcfg


def port_step(pipe, blip, tcfg, batch, draws, **init_kw):
    """One `make_train_step` step: (metrics, the gradients on the masters
    as the backward left them, before the clip, the masters after the
    step, the train state), numpy by trainable name."""
    state = tts.init_train_state(pipe, tcfg, **init_kw)
    opt = state.optimizer
    grads = {}
    step_fn = opt.step

    def recording_step():
        for n, m in opt.masters.items():
            grads[n] = (m.grad if m.grad is not None else torch.zeros_like(m)).numpy().copy()
        return step_fn()

    opt.step = recording_step
    state, metrics = tts.make_train_step(pipe, blip, tcfg)(state, batch, draws)
    after = {n: m.detach().float().numpy().copy() for n, m in opt.masters.items()}
    return metrics, grads, after, state


def assert_step_matches(case, metrics, grads, after, must=()):
    """The loss, and each trainable leaf's gradient and post-step value,
    against JAX's; `must`: name prefixes that must be among the leaves."""
    assert abs(metrics["step_loss"] - case["loss"]) <= LOSS_TOL, (metrics, case["loss"])
    assert set(grads) == set(case["grads"]), sorted(set(grads) ^ set(case["grads"]))[:5]
    for prefix in must:
        assert any(n.startswith(prefix) for n in grads), prefix
    top = max(np.abs(w).max() for w in case["grads"].values())
    noise = {n for n, w in case["grads"].items() if np.abs(w).max() < ZERO_LEAF * top}
    worst = max((rel(grads[n], w), n) for n, w in case["grads"].items() if n not in noise)
    assert worst[0] <= GRAD_TOL, worst
    for n in noise:
        assert np.abs(grads[n] - case["grads"][n]).max() <= GRAD_TOL * top, n
    zero = {n for n, v in case["before"].items() if not np.any(v)}
    worst = max((rel(after[n], w), n) for n, w in case["after"].items()
                if n not in zero | noise)
    assert worst[0] <= GRAD_TOL, worst
    cfg = case["jcfg"]

    def clip(gs):
        norm = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64)) for v in gs.values()))
        return min(1.0, cfg.max_grad_norm / norm) if norm else 1.0

    port_clip, jax_clip = clip(grads), clip(case["grads"])
    for n in zero:
        text = n.split(".")[0] in ("text", "text2") and cfg.textenc_lr is not None
        lr = cfg.textenc_lr if text else cfg.learning_rate
        g = grads[n].astype(np.float64) * port_clip
        update = -lr * g / (np.abs(g) + cfg.adam_eps)
        assert rel(after[n], update) <= 1e-6, n
        if n in noise:
            continue
        gj = np.abs(case["grads"][n].astype(np.float64)) * jax_clip
        fixed = gj * (gj + cfg.adam_eps) >= cfg.adam_eps * gj.max()
        assert rel(after[n][fixed], case["after"][n][fixed]) <= GRAD_TOL, n
