"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and skip without one. The file imports
no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: fp32 1e-4 absolute (the same sums in another order, TF32
off); bf16 |kernel - plain| <= 1e-2 + 2^-7 |plain|, since both round an
fp32 result to bf16 and may land one bf16 step apart.
"""

import math

import pytest
import torch

from comat_tpu_torch.ops import conv3x3 as cv
from comat_tpu_torch.ops import flash_attention as fa

TOLS = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 2.0 ** -7)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _assert_close(got, want, dtype):
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # (B, H, Sq, Skv, d)
    (2, 8, 1024, 1024, 40), (2, 8, 1024, 1024, 80), (2, 8, 256, 256, 160),
    (1, 1, 1024, 1024, 512), (1, 2, 100, 200, 40), (1, 3, 77, 300, 64),
])
def test_flash_kernel_matches_plain(card, dtype, shape):
    B, H, Sq, Skv, d = shape
    q, k, v = (
        torch.randn(B, S, H, d, generator=card, device="cuda").to(dtype).transpose(1, 2)
        for S in (Sq, Skv, Skv)
    )
    before = fa.KERNEL.launches
    o, lse = fa.flash_attention(q, k, v, want_lse=True)
    assert fa.KERNEL.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v)
    assert o.shape == (B, H, Sq, d) and lse.shape == (B, H, Sq)
    _assert_close(o, o_ref, dtype)
    _assert_close(lse, lse_ref, dtype)
    torch.testing.assert_close(fa.flash_attention(q, k, v), o, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # (B, H, C, Cout)
    (1, 16, 8, 16), (2, 24, 16, 20), (1, 128, 128, 136), (2, 128, 256, 128),
])
def test_conv_kernel_matches_plain(card, dtype, shape):
    B, H, C, Cout = shape
    x = torch.randn(B, H, H, C, generator=card, device="cuda").to(dtype)
    w = (torch.randn(3, 3, C, Cout, generator=card, device="cuda")
         / math.sqrt(9 * C)).to(dtype)
    before = cv.KERNEL.launches
    y = cv.conv3x3_same(x, w)
    assert cv.KERNEL.launches == before + 1
    _assert_close(y, cv.conv3x3_ref(x, w), dtype)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    x = torch.zeros(1, 16, 16, 12, device="cuda")
    with pytest.raises(ValueError):
        cv.conv3x3_same(x, torch.zeros(3, 3, 12, 16, device="cuda"))  # C % 8
    q = torch.zeros(1, 1, 8, 520, device="cuda")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)                                    # d > 512
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., :8].half(), q[..., :8].half(), q[..., :8].half())
