"""Port flash attention (comat_tpu_torch/ops/flash_attention.py) against
the JAX Pallas kernel run in interpret mode.

Same inputs, made with numpy from a seed, go to both. Tolerance 1e-5
absolute in fp32: the two sum the same products in another order, and
the outputs are convex combinations of unit-scale values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comat_tpu.ops.flash_attention as jfa
from comat_tpu_torch.ops import flash_attention as tfa
from comat_tpu_torch.ops.attention import multi_head_attention

TOL = 1e-5

SHAPES = [
    # (B, H, Sq, Skv, d)
    (1, 2, 128, 136, 40),    # SD1.5 64^2 self-attention head dim
    (1, 2, 64, 64, 160),     # SD1.5 16^2 head dim
    (1, 2, 72, 200, 40),     # ragged key count
    (1, 1, 32, 48, 512),     # the VAE's single head
]


def _qkv(shape, seed=0):
    B, H, Sq, Skv, d = shape
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((B, H, S, d)).astype(np.float32)
        for S in (Sq, Skv, Skv)
    ]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape):
    q, k, v = _qkv(shape)
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True
    ))
    _, lse_pad, _ = jfa._fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), want_lse=True,
        interpret=True,
    )
    B, H, Sq, _, _ = shape
    want_lse = np.asarray(lse_pad)[:, 0, :Sq].reshape(B, H, Sq)
    o, lse = tfa.flash_attention_ref(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(o.numpy(), want, atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_wrapper_on_cpu_takes_plain_version(shape):
    """A CPU tensor, here a strided (B, S, H, d) head split, goes to the
    plain version; o and lse match it exactly."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(shape, seed=1))
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    o, lse = tfa.flash_attention(qs, ks, vs, want_lse=True)
    o_ref, lse_ref = tfa.flash_attention_ref(q, k, v)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert torch.equal(tfa.flash_attention(qs, ks, vs), o_ref)


def test_wrapper_refuses_other_devices():
    q = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)


def test_multi_head_attention_matches_jax():
    from comat_tpu.ops.attention import multi_head_attention as jmha

    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 150, 64)).astype(np.float32)
    k = rng.standard_normal((2, 150, 64)).astype(np.float32)
    v = rng.standard_normal((2, 150, 64)).astype(np.float32)
    want, _ = jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4,
                   use_pallas=False)
    got = multi_head_attention(*map(torch.from_numpy, (q, k, v)), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)



@pytest.mark.parametrize("shape", [
    (1, 2, 128, 256, 40), (1, 2, 128, 1100, 40), (1, 1, 64, 300, 512),
])
def test_plain_rounds_where_pallas_rounds_in_bf16(shape):
    """bf16: P rounded to v's dtype before P*V and the denominator summed
    from the rounded P, as the JAX kernel does. The kernel takes its max
    per 1024-key block and the plain version over all keys, so a few
    outputs may land one bf16 step (2^-8 at these magnitudes) apart: at
    most 5 % of them, none by more. Without the rounding, 40 % differ.
    Past 1024 keys, where the kernel rescales, 3-5 % differ over seeds
    0-3; this test takes seed 0, as the others here do."""
    q, k, v = _qkv(shape)
    want = np.asarray(jfa.flash_attention(
        *(jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)), interpret=True
    ).astype(jnp.float32))
    o, _ = tfa.flash_attention_ref(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    diff = np.abs(o.float().numpy() - want)
    assert diff.max() <= 2.0 ** -8
    assert (diff > 0).mean() <= 0.05
