"""Port 3x3 conv (comat_tpu_torch/ops/conv3x3.py, models/conv.py) against
the JAX Pallas kernel run in interpret mode and the JAX Conv3x3 module.

Same inputs, made with numpy from a seed, go to both. Tolerance 1e-4
absolute in fp32: 9*C products summed in another order, outputs of order
one.
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


def _xw(B, H, C, Cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, H, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, Cout)) / np.sqrt(9 * C)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", [(1, 16, 8, 16), (2, 24, 12, 20)])
def test_plain_matches_pallas_interpret(shape):
    x, w = _xw(*shape)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jconv(jnp.asarray(x), jnp.asarray(w)))
    got = tconv.conv3x3_ref(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(
        tconv.conv3x3_same(torch.from_numpy(x), torch.from_numpy(w)), got
    )


@pytest.mark.parametrize(
    "shape,hits_kernel_gate",
    [((2, 8, 12, 7), False), ((1, 128, 128, 128), True)],
)
def test_conv3x3_module_matches_jax(shape, hits_kernel_gate):
    """The module with weights carried from the JAX module (HWIO ->
    OIHW), on channels_last input; the second shape passes the kernel
    gate and so runs the wrapper's plain version here."""
    from comat_tpu.models.conv import Conv3x3 as JConv3x3

    B, H, C, Cout = shape
    x, _ = _xw(B, H, C, Cout, seed=1)
    jmod = JConv3x3(Cout)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.asarray(params["params"]["kernel"])
    bias = np.random.default_rng(2).standard_normal(Cout).astype(np.float32)
    params = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))

    assert tconv.use_conv_kernel(x.shape, kernel.shape) == hits_kernel_gate
    mod = Conv3x3(C, Cout)
    mod.load_state_dict({
        "weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
        "bias": torch.from_numpy(bias),
    })
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)   # channels_last NCHW
    with torch.no_grad():
        got = mod(xt).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_gate_on_the_sd15_decoder_shapes():
    """At 512^2 the gate admits the 128^2..512^2 convs with >= 128
    channels and keeps the 64^2 ones and the 3-channel output conv out."""
    gate = tconv.use_conv_kernel
    assert gate((2, 128, 128, 512), (3, 3, 512, 512))
    assert gate((2, 512, 512, 256), (3, 3, 256, 128))
    assert not gate((2, 64, 64, 512), (3, 3, 512, 512))
    assert not gate((2, 512, 512, 128), (3, 3, 128, 3))
    assert not gate((2, 64, 64, 4), (3, 3, 4, 512))


def test_wrapper_refuses_other_devices():
    x = torch.zeros(1, 8, 8, 8, device="meta")
    with pytest.raises(ValueError):
        tconv.conv3x3_same(x, torch.zeros(3, 3, 8, 8, device="meta"))



def test_gate_needs_channels_the_kernel_takes_both_ways():
    """dx runs the forward kernel with C and Cout swapped, and the kernel
    takes channel counts that are multiples of 8: the gate asks that of
    both, as the JAX gate checks both directions."""
    gate = tconv.use_conv_kernel
    assert gate((2, 128, 128, 136), (3, 3, 136, 256))
    assert not gate((2, 128, 128, 136), (3, 3, 136, 130))
    assert not gate((2, 128, 128, 130), (3, 3, 130, 136))
