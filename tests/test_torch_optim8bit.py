"""The port's 8-bit AdamW (comat_tpu_torch/training/optim8bit.py, and
`ClippedAdamW` with `use_8bit_adam`) against the JAX package's
(comat_tpu/training/optim8bit.py, `train_step.make_optimizer`).

- `quantize`: the int8 codes equal JAX's `_quantize`'s and the fp32
  scales equal too, on sizes that are and are not multiples of the
  2048-value block, an all-zero block included; `dequantize` inverts it
  as JAX's `_dequantize` does.
- 5 steps of `ClippedAdamW(use_8bit_adam)` under a joint global-norm clip
  that cuts every step, with a --textenc_lora_lr group over "text" and
  "text2", against JAX's `make_optimizer` (optax.chain(clip,
  multi_transform(adamw_8bit))) on the same gradients: the tensors within
  1e-6 absolute, the codes of both moments equal; and the same inside
  gradient accumulation (N 2, 10 micro-steps: 5 updates, JAX's
  `optax.MultiSteps`).
- The state round-trips through a checkpoint: a run restored after 3
  steps ends its 5th as the uninterrupted run, bit for bit, its codes
  int8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu.training import optim8bit as joptim
from comat_tpu.training import train_step as jts
from comat_tpu_torch.training import checkpoints as tckpt
from comat_tpu_torch.training import optim8bit as toptim
from comat_tpu_torch.training import train_step as tts

SHAPES = {"unet.a": (64, 96), "unet.b": (5000,), "text.c": (2048,), "text2.d": (3, 7)}
LR, TEXT_LR, STEPS = 1e-3, 3e-3, 5
ATOL = 1e-6


def _sample(shape, rng):
    x = rng.standard_normal(shape).astype(np.float32)
    if x.size > 2 * 2048:
        x.reshape(-1)[2048:4096] = 0.0       # an all-zero block
    return x


@pytest.mark.parametrize("n", [1, 7, 2048, 4096, 5000, 3 * 2048 + 5])
def test_quantize_matches_jax(n):
    x = _sample((n,), np.random.default_rng(n)) * 3.0
    jq, js = joptim._quantize(jnp.asarray(x))
    tq, ts = toptim.quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if n > 4096:
        assert ts[1] == 0 and (tq[1] == 0).all()
    got = toptim.dequantize(tq, ts, (n,)).numpy()
    np.testing.assert_array_equal(got, np.asarray(joptim._dequantize(jq, js, (n,))))


def _configs(every=1):
    kw = dict(learning_rate=LR, textenc_lr=TEXT_LR, max_grad_norm=0.1, use_8bit_adam=True,
              gradient_accumulation_steps=every)
    return jts.TrainConfig(**kw), tts.TrainConfig(**kw)


def _jax_tree(flat):
    tree = {}
    for name, v in flat.items():
        tower, leaf = name.split(".")
        tree.setdefault(tower, {})[leaf] = jnp.asarray(v)
    return tree


def _port_run(params0, grads, steps, opt=None, tensors=None, every=1):
    _, tcfg = _configs(every)
    if tensors is None:
        tensors = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
                   for n, v in params0.items()}
        opt = tts.make_optimizer(tcfg, tensors)
    for g in grads[:steps]:
        opt.zero_grad()
        for n, p in tensors.items():
            p.grad = torch.from_numpy(g[n].copy())
        opt.step()
    return tensors, opt


def _jax_run(every):
    rng = np.random.default_rng(0)
    params0 = {n: _sample(s, rng) for n, s in SHAPES.items()}
    grads = [{n: _sample(s, rng) * (i + 1) for n, s in SHAPES.items()}
             for i in range(STEPS * every)]
    jcfg, _ = _configs(every)
    opt = jts.make_optimizer(jcfg)
    params = _jax_tree(params0)
    state = opt.init(params)
    norms = []
    for g in grads:
        jg = _jax_tree(g)
        norms.append(float(jnp.sqrt(sum(jnp.sum(x * x) for x in jax.tree_util.tree_leaves(jg)))))
        updates, state = opt.update(jg, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    if every > 1:
        state = state.inner_opt_state
    return params0, grads, params, state, norms


@pytest.fixture(scope="module")
def run():
    return _jax_run(1)


@pytest.mark.parametrize("every", [1, 2])
def test_8bit_adamw_under_the_clip_with_a_text_group_matches_optax(run, every):
    params0, grads, want, jstate, norms = run if every == 1 else _jax_run(every)
    assert min(norms) > 0.1      # the clip cuts every step
    tensors, opt = _port_run(params0, grads, len(grads), every=every)
    assert isinstance(opt.adam, toptim.AdamW8bit) and len(opt.adam.param_groups) == 2
    assert opt.count == STEPS
    assert [g["lr"] for g in opt.adam.param_groups] == [LR, TEXT_LR]
    for name, p in tensors.items():
        tower, leaf = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[tower][leaf]),
                                   atol=ATOL, rtol=0, err_msg=name)
    # optax.chain(clip, multi_transform({"main", "text"})): the adam state
    inner = jstate[1].inner_states
    for name, p in tensors.items():
        tower, leaf = name.split(".")
        label = "text" if tower in ("text", "text2") else "main"
        adam8 = inner[label].inner_state[0]
        st = opt.adam.state[p]
        assert st["step"] == int(adam8.count) == STEPS
        for mom, jm in (("mu", adam8.mu), ("nu", adam8.nu)):
            np.testing.assert_array_equal(st[f"{mom}_q"].numpy(),
                                          np.asarray(jm[tower][leaf].q), err_msg=name)


def test_8bit_state_round_trips_through_a_checkpoint(run, tmp_path):
    params0, grads, _, _, _ = run
    full, full_opt = _port_run(params0, grads, STEPS)
    first, first_opt = _port_run(params0, grads, 3)
    state = tts.TrainState(3, first, first_opt)
    tckpt.save_checkpoint(str(tmp_path), 3, state)
    _, tcfg = _configs()
    tensors = {n: torch.nn.Parameter(torch.zeros(s)) for n, s in SHAPES.items()}
    opt = tts.make_optimizer(tcfg, tensors)
    step, _ = tckpt.restore_checkpoint(str(tmp_path / "checkpoint-3"),
                                       tts.TrainState(0, tensors, opt))
    assert step == 3 and opt.count == 3
    codes = [st[k] for st in opt.adam.state.values() for k in ("mu_q", "nu_q")]
    assert len(codes) == 2 * len(SHAPES) and all(c.dtype == torch.int8 for c in codes)
    _port_run(None, grads[3:], 2, opt, tensors)
    for name, p in tensors.items():
        assert torch.equal(p.detach(), full[name].detach()), name
        for k, v in full_opt.adam.state[full[name]].items():
            got = opt.adam.state[p][k]
            assert (got == v) if not isinstance(v, torch.Tensor) else torch.equal(got, v), k
