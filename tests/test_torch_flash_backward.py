"""The port's flash-attention backward (comat_tpu_torch/ops/flash_attention.py)
against the JAX `flash_attention_diff` VJP, its Pallas backward kernels
run in interpret mode, and against autograd of the plain attention.

On the CPU the port's differentiable Function takes the plain versions
(`flash_attention_ref` forward, `flash_attention_bwd_ref` backward); the
CUDA kernels are held to those same plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py). Same numpy inputs and
output cotangent on both sides. Tolerance 1e-5 absolute in fp32: the
same sums in another order, with inputs scaled so that every gradient is
of order one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import comat_tpu.ops.flash_attention as jfa
from comat_tpu_torch.ops import flash_attention as tfa
from comat_tpu_torch.ops.attention import attention_plain

TOL = 1e-5

SHAPES = [
    # (B, H, Sq, Skv, d): the train path's head dims at short lengths
    (1, 2, 64, 64, 40),
    (1, 2, 32, 32, 80),
    (1, 2, 16, 16, 160),
    (1, 1, 16, 16, 512),
    (1, 2, 40, 72, 40),     # ragged: Sq != Skv, neither a tile multiple
]


def _inputs(shape, seed=0):
    B, H, Sq, Skv, d = shape
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, d)).astype(np.float32)
               for S in (Sq, Skv, Skv))
    do = (rng.standard_normal((B, H, Sq, d)) * np.sqrt(Sq)).astype(np.float32)
    return q, k, v, do


def _port_grads(attn, q, k, v, do):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = attn(*ts)
    o.backward(torch.tensor(do))
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_pallas_interpret(shape):
    q, k, v, do = _inputs(shape)
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(jfa.flash_attention_diff, *map(jnp.asarray, (q, k, v)))
        want = vjp(jnp.asarray(do))
    got_o, got = _port_grads(tfa.flash_attention_diff, q, k, v, do)
    np.testing.assert_allclose(got_o, np.asarray(o), atol=TOL, rtol=0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_function_matches_plain_autograd(shape):
    """The Function's backward (dO * o row sums, then the dq and dk/dv
    formulas) equals autograd through the plain materialised attention."""
    q, k, v, do = _inputs(shape, seed=1)
    got_o, got = _port_grads(tfa.flash_attention_diff, q, k, v, do)
    want_o, want = _port_grads(attention_plain, q, k, v, do)
    np.testing.assert_allclose(got_o, want_o, atol=TOL, rtol=0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


BF16_SHAPES = [(1, 2, 128, 256, 40), (1, 2, 64, 200, 80), (1, 1, 32, 100, 512)]


def _bf16_agrees(got, want, name):
    """At most 1 % of the outputs differ, and none by more than one bf16
    step of the JAX gradient (2^-7 of the binade of its largest value):
    both sides round fp32 sums taken in another order to bf16 at the same
    points. The step is the gradient's, not each output's own: where a
    sum cancels, a small output carries the rounding of its large terms."""
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, name
    diff = np.abs(got - want)
    step = np.exp2(np.floor(np.log2(np.abs(want).max())) - 7)
    assert diff.max() <= step, (name, float(diff.max()), float(step))
    assert np.mean(diff > 0) <= 0.01, (name, float(np.mean(diff > 0)))


@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_bf16_backward_rounds_where_pallas_rounds(shape):
    """The port's plain bf16 backward, and `flash_attention_diff` end to
    end, against JAX's `_flash_diff_bwd` on its own residuals, the Pallas
    kernels in interpret mode: P is rounded to dO's dtype before dv, dS
    to k's and q's before dq and dk, and every sum is fp32."""
    B, H, Sq, Skv, d = shape
    q, k, v, do = (torch.tensor(a).to(torch.bfloat16) for a in _inputs(shape))
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
                       for t in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        _, res = jfa._flash_diff_fwd(jq, jk, jv)
        want = [np.asarray(w.astype(jnp.float32))
                for w in jfa._flash_diff_bwd(res, jdo)]
    # JAX's residuals: the padded output and the LSE broadcast over 8 rows
    o = torch.tensor(np.asarray(res[3][:, :Sq, :d].astype(jnp.float32)))
    o = o.reshape(B, H, Sq, d).to(torch.bfloat16)
    lse = torch.tensor(np.asarray(res[4][:, 0, :Sq])).reshape(B, H, Sq)
    dvec = (do.float() * o.float()).sum(-1)
    plain = tfa.flash_attention_bwd_ref(q, k, v, do, lse, dvec)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    tfa.flash_attention_diff(*ts).backward(do)
    for name, p, t, w in zip(("dq", "dk", "dv"), plain, ts, want):
        assert p.dtype == torch.bfloat16 and t.grad.dtype == torch.bfloat16
        _bf16_agrees(p.float().numpy(), w, f"plain {name}")
        _bf16_agrees(t.grad.float().numpy(), w, f"end to end {name}")


def test_bwd_wrapper_takes_plain_version_on_cpu():
    q, k, v, do = (torch.tensor(a) for a in _inputs(SHAPES[-1], seed=2))
    o, lse = tfa.flash_attention(q, k, v, want_lse=True)
    dvec = (do * o).sum(-1)
    got = tfa.flash_attention_bwd(q, k, v, do, lse, dvec)
    want = tfa.flash_attention_bwd_ref(q, k, v, do, lse, dvec)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tfa.flash_attention_diff(q, k, v).grad_fn is None   # nothing records
