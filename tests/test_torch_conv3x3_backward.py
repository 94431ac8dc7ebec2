"""The port's 3x3 conv backward (comat_tpu_torch/ops/conv3x3.py: dx
through the forward kernel with flipped io-transposed weights, dw) against
the JAX `conv3x3_same` VJP, its Pallas kernels run in interpret mode, and
against autograd of the plain version.

On the CPU the port's Function takes the plain versions (`conv3x3_ref`
for the forward and dx, `conv3x3_dw_ref` for dw); the CUDA kernels are
held to those on the card. Same numpy inputs and cotangent on both sides.
Tolerance 1e-4 absolute in fp32: 9*C (dx) or B*H*W (dw) products summed
in another order, with dy scaled so that dw is of order one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from comat_tpu.ops.conv3x3 import conv3x3_same as jconv
from comat_tpu_torch.models.conv import Conv3x3
from comat_tpu_torch.ops import conv3x3 as tconv

TOL = 1e-4
SHAPES = [(1, 16, 8, 16), (2, 24, 16, 8), (1, 8, 24, 32)]   # (B, H, C, Cout)


def _inputs(B, H, C, Cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, H, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, Cout)) / np.sqrt(9 * C)).astype(np.float32)
    dy = (rng.standard_normal((B, H, H, Cout)) / np.sqrt(B * H * H)).astype(np.float32)
    return x, w, dy


def _port_grads(conv, x, w, dy):
    xt, wt = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    conv(xt, wt).backward(torch.tensor(dy))
    return xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_dx_dw_match_pallas_interpret(shape):
    x, w, dy = _inputs(*shape)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jconv, jnp.asarray(x), jnp.asarray(w))
        want = vjp(jnp.asarray(dy))
    for g, want_g in zip(_port_grads(tconv.conv3x3_same, x, w, dy), want):
        np.testing.assert_allclose(g, np.asarray(want_g), atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_dx_dw_round_where_pallas_rounds(shape):
    """bf16 x, w and dy: JAX's `_vjp_bwd`, its Pallas kernels in interpret
    mode, sums the products of the bf16 operands in fp32 and rounds once,
    to the input dtype for dx and to w's for dw (`_conv_dw_kernel`); the
    port's Function on the CPU (its plain versions) rounds at the same
    points. Sums in another order land on either side of a bf16 midpoint
    now and then: at most 1 % of the outputs differ, each by at most one
    bf16 step of its own value (2^-7 of its binade). Rounding a partial
    sum (a strip of rows at a time), or summing in bf16, would move most
    of them."""
    x, w, dy = (torch.tensor(a).to(torch.bfloat16) for a in _inputs(*shape, seed=3))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jconv, *(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
                                  for t in (x, w)))
        want = vjp(jnp.asarray(dy.float().numpy(), dtype=jnp.bfloat16))
    xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
    tconv.conv3x3_same(xt, wt).backward(dy)
    for name, g, want_g in (("dx", xt.grad, want[0]), ("dw", wt.grad, want[1])):
        assert g.dtype == torch.bfloat16 and want_g.dtype == jnp.bfloat16, name
        got, ref = g.float().numpy(), np.asarray(want_g.astype(jnp.float32))
        diff = np.abs(got - ref)
        step = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (diff <= step).all(), (name, float((diff / step).max()))
        assert np.mean(diff > 0) <= 0.01, (name, float(np.mean(diff > 0)))


@pytest.mark.parametrize("shape", SHAPES)
def test_function_matches_plain_autograd(shape):
    x, w, dy = _inputs(*shape, seed=1)
    got = _port_grads(tconv.conv3x3_same, x, w, dy)
    want = _port_grads(tconv.conv3x3_ref, x, w, dy)
    for g, want_g in zip(got, want):
        np.testing.assert_allclose(g, want_g, atol=TOL, rtol=0)
    # dw alone, as the wrapper computes it
    dw = tconv.conv3x3_dw(torch.tensor(x), torch.tensor(dy), torch.float32)
    np.testing.assert_allclose(dw.numpy(), want[1], atol=TOL, rtol=0)


def test_frozen_weight_skips_dw():
    """With the weight frozen (the default recipe's VAE), the backward
    keeps no x and returns dx only."""
    x, w, dy = _inputs(*SHAPES[0], seed=2)
    xt = torch.tensor(x, requires_grad=True)
    y = tconv.conv3x3_same(xt, torch.tensor(w))
    assert y.grad_fn is not None and y.grad_fn.saved_tensors[0] is None
    y.backward(torch.tensor(dy))
    assert xt.grad is not None


def test_module_backward_matches_nn_conv2d():
    """The Conv3x3 module at a shape that passes the kernel gate (its
    plain version here): input, weight and bias gradients equal those of
    F.conv2d through the same weights."""
    torch.manual_seed(0)
    mod = Conv3x3(128, 128)
    x = torch.randn(1, 128, 128, 128).to(memory_format=torch.channels_last)
    assert tconv.use_conv_kernel((1, 128, 128, 128), (3, 3, 128, 128))
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    dy = torch.randn(1, 128, 128, 128) / 128
    mod(xa).backward(dy)
    got = [xa.grad.clone(), mod.weight.grad.clone(), mod.bias.grad.clone()]
    mod.zero_grad()
    torch.nn.functional.conv2d(xb, mod.weight, mod.bias, padding=1).backward(dy)
    for g, w in zip(got, [xb.grad, mod.weight.grad, mod.bias.grad]):
        torch.testing.assert_close(g, w, atol=TOL, rtol=1e-5)
