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


def test_bwd_wrapper_takes_plain_version_on_cpu():
    q, k, v, do = (torch.tensor(a) for a in _inputs(SHAPES[-1], seed=2))
    o, lse = tfa.flash_attention(q, k, v, want_lse=True)
    dvec = (do * o).sum(-1)
    got = tfa.flash_attention_bwd(q, k, v, do, lse, dvec)
    want = tfa.flash_attention_bwd_ref(q, k, v, do, lse, dvec)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tfa.flash_attention_diff(q, k, v).grad_fn is None   # nothing records
