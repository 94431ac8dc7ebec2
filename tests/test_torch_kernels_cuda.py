"""The CUDA kernels against their plain PyTorch versions, on the card:
flash attention forward and backward (dq; dk and dv), the 3x3 conv
forward, its dx (the forward kernel through the autograd Function) and
its dw.

These tests need an NVIDIA card and skip without one. The file imports
no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: fp32 1e-4 absolute (the same sums in another order, TF32
off); bf16 |kernel - plain| <= 1e-2 + 2^-7 |plain|, since both round an
fp32 result to bf16 and may land one bf16 step apart. The bf16 backward
also rounds dS and P to bf16 inside; its plain version sums each product
of bf16 operands on the tensor cores (cuBLAS's bf16 GEMM, as the kernels
and JAX's dot_general do), so both round the same dS. The backward
inputs are scaled so that every gradient is of order one (dO by
sqrt(Sq), dy by 1/sqrt(B*H*W) for dw), so that the absolute tolerance
means the same there.
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
    # ragged edges of the tensor-core tiles (128 q rows, 32-128 keys)
    (1, 2, 200, 333, 40), (1, 2, 191, 257, 80), (1, 2, 129, 65, 160),
    (1, 1, 300, 130, 512), (2, 3, 33, 200, 40), (1, 1, 17, 50, 512),
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
    # ragged edges of the tensor-core tile (2 rows x 64 columns, 128 out
    # channels, 64-channel chunks): W = 100 and 72, C = 8 and 136, Cout =
    # 20 and 136
    (1, 100, 136, 20), (2, 72, 8, 136), (1, 100, 136, 136),
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
    q12 = torch.zeros(1, 1, 8, 12, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(q12, q12, q12)      # bf16 TMA rows: d % 8


def _flash_inputs(card, shape, dtype):
    B, H, Sq, Skv, d = shape
    q, k, v, do = (
        torch.randn(B, S, H, d, generator=card, device="cuda").to(dtype).transpose(1, 2)
        for S in (Sq, Skv, Skv, Sq)
    )
    return q, k, v, (do.float() * math.sqrt(Sq)).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # (B, H, Sq, Skv, d)
    (2, 8, 1024, 1024, 40), (2, 8, 512, 512, 80), (2, 8, 256, 256, 160),
    (1, 1, 1024, 1024, 512), (1, 2, 100, 200, 40), (1, 3, 77, 300, 64),
    (1, 1, 50, 40, 512),
    # ragged edges of the tensor-core tiles (64-row blocks of queries or
    # keys per warpgroup, 16-64-row streamed tiles, column blocks at d =
    # 160 and 512), and Sq < 64 with Skv under one key tile
    (1, 2, 200, 333, 40), (1, 2, 191, 257, 80), (1, 2, 129, 65, 160),
    (1, 1, 300, 130, 512), (2, 3, 33, 50, 40), (1, 2, 20, 9, 80),
])
def test_flash_backward_kernels_match_plain(card, dtype, shape):
    q, k, v, do = _flash_inputs(card, shape, dtype)
    o, lse = fa.flash_attention(q, k, v, want_lse=True)
    dvec = (do.float() * o.float()).sum(-1)
    n_dq, n_dkv = fa.DQ_KERNEL.launches, fa.DKV_KERNEL.launches
    got = fa.flash_attention_bwd(q, k, v, do, lse, dvec)
    assert (fa.DQ_KERNEL.launches, fa.DKV_KERNEL.launches) == (n_dq + 1, n_dkv + 1)
    want = fa.flash_attention_bwd_ref(q, k, v, do, lse, dvec)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dtype
        _assert_close(g, w, dtype)
    # each output row is written by one block: a second run is bitwise equal
    for g, g2 in zip(got, fa.flash_attention_bwd(q, k, v, do, lse, dvec)):
        assert torch.equal(g, g2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_takes_any_do_layout(card, dtype):
    """A `do` whose row stride breaks the TMA rules (41 elements) gives
    the same gradients, bit for bit, as the same values laid out densely:
    the wrapper copies it, and the kernels still run."""
    q, k, v, do = _flash_inputs(card, (1, 2, 150, 190, 40), dtype)
    o, lse = fa.flash_attention(q, k, v, want_lse=True)
    dvec = (do.float() * o.float()).sum(-1)
    wide = torch.zeros(*do.shape[:3], 41, dtype=dtype, device="cuda")
    wide[..., :40] = do
    odd = wide[..., :40]
    assert odd.stride(2) == 41
    n_dq = fa.DQ_KERNEL.launches
    got = fa.flash_attention_bwd(q, k, v, odd, lse, dvec)
    assert fa.DQ_KERNEL.launches == n_dq + 1
    for g, w in zip(got, fa.flash_attention_bwd(q, k, v, do.contiguous(), lse, dvec)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # (B, H, C, Cout)
    (1, 16, 8, 16), (2, 24, 16, 24), (1, 128, 128, 136), (2, 128, 256, 128),
    (1, 100, 136, 136),
])
def test_conv_backward_kernels_match_plain(card, dtype, shape):
    B, H, C, Cout = shape
    x = torch.randn(B, H, H, C, generator=card, device="cuda").to(dtype)
    w = (torch.randn(3, 3, C, Cout, generator=card, device="cuda")
         / math.sqrt(9 * C)).to(dtype)
    dy = torch.randn(B, H, H, Cout, generator=card, device="cuda").to(dtype)
    n_fwd, n_dw = cv.KERNEL.launches, cv.DW_KERNEL.launches
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    cv.conv3x3_same(xr, wr).backward(dy)
    assert (cv.KERNEL.launches, cv.DW_KERNEL.launches) == (n_fwd + 2, n_dw + 1)
    xp, wp = x.float().requires_grad_(), w.float().requires_grad_()
    cv.conv3x3_ref(xp, wp).backward(dy.float())   # plain vjp, fp32
    _assert_close(xr.grad, xp.grad, dtype)
    dy_s = (dy.float() / math.sqrt(B * H * H)).to(dtype)
    dw = cv.conv3x3_dw(x, dy_s, dtype)
    _assert_close(dw, cv.conv3x3_dw_ref(x, dy_s, dtype), dtype)
    assert torch.equal(dw, cv.conv3x3_dw(x, dy_s, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    # (B, H, W, C, Cout): ragged rows of the 64-column pixel step (W = 100,
    # 50, 130, 9, 70), C and Cout multiples of 8 but not of the 64-channel
    # box or the 128/256-column tile (136, 200, 264), Cout % 8 != 0 (padded
    # in dy), B > 1, a split pixel sum (4 x 128^2); both operand roles
    # (Cout % 256 == 0: x rows by 256 output channels, else 128 output
    # channels by x rows), an odd count of row boxes (C = 64: 9) and two
    # output-channel blocks (Cout = 512)
    (1, 100, 100, 136, 136), (2, 37, 50, 8, 16), (3, 65, 130, 128, 264),
    (2, 33, 9, 136, 264), (1, 40, 40, 16, 20), (4, 128, 128, 128, 128),
    (2, 64, 64, 256, 256), (2, 30, 70, 64, 256), (1, 24, 130, 200, 512),
])
def test_dw_bf16_kernel_matches_plain(card, shape):
    B, H, W, C, Cout = shape
    x = torch.randn(B, H, W, C, generator=card, device="cuda").to(torch.bfloat16)
    dy = (torch.randn(B, H, W, Cout, generator=card, device="cuda")
          / math.sqrt(B * H * W)).to(torch.bfloat16)
    n_dw = cv.DW_KERNEL.launches
    dw = cv.conv3x3_dw(x, dy, torch.bfloat16)
    assert cv.DW_KERNEL.launches == n_dw + 1
    assert dw.shape == (3, 3, C, Cout) and dw.dtype == torch.bfloat16
    _assert_close(dw, cv.conv3x3_dw_ref(x, dy, torch.bfloat16), torch.bfloat16)
    # a fixed-order reduction of the pixel splits: a second run is bitwise equal
    assert torch.equal(dw, cv.conv3x3_dw(x, dy, torch.bfloat16))


@pytest.mark.cuda
def test_conv_module_trains_a_bf16_weight(card):
    """The Conv3x3 module in bf16 with a trainable weight, at a shape that
    passes the kernel gate: its backward launches dx and dw, and the
    weight and bias gradients match the plain vjp."""
    from comat_tpu_torch.models.conv import Conv3x3

    torch.manual_seed(0)
    mod = Conv3x3(128, 136, dtype=torch.bfloat16, device="cuda").requires_grad_(True)
    x = torch.randn(2, 128, 128, 128, generator=card, device="cuda").to(
        torch.bfloat16).to(memory_format=torch.channels_last)
    dy = (torch.randn(2, 136, 128, 128, generator=card, device="cuda")
          / 128).to(torch.bfloat16)
    n_fwd, n_dw = cv.KERNEL.launches, cv.DW_KERNEL.launches
    y = mod(x)
    assert y.grad_fn is not None
    y.backward(dy)
    assert (cv.KERNEL.launches, cv.DW_KERNEL.launches) == (n_fwd + 1, n_dw + 1)
    assert mod.weight.grad.dtype == torch.bfloat16
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()
    dy_nhwc = dy.permute(0, 2, 3, 1).contiguous()
    want = cv.conv3x3_dw_ref(x_nhwc, dy_nhwc, torch.bfloat16).permute(3, 2, 0, 1)
    _assert_close(mod.weight.grad, want, torch.bfloat16)
    _assert_close(mod.bias.grad, dy.float().sum((0, 2, 3)), torch.bfloat16)


@pytest.mark.cuda
def test_kernel_outputs_carry_grad_fn(card):
    """A kernel's output records its backward when an input requires
    grad; the frozen-weight conv skips dw."""
    q = torch.randn(1, 2, 256, 40, generator=card, device="cuda", requires_grad=True)
    o = fa.flash_attention_diff(q, q.detach(), q.detach())
    assert o.grad_fn is not None
    n_dq = fa.DQ_KERNEL.launches
    o.sum().backward()
    assert fa.DQ_KERNEL.launches == n_dq + 1 and q.grad is not None
    x = torch.randn(1, 128, 128, 128, generator=card, device="cuda", requires_grad=True)
    w = torch.randn(3, 3, 128, 128, generator=card, device="cuda") / 34.0
    y = cv.conv3x3_same(x, w)
    assert y.grad_fn is not None
    n_dw = cv.DW_KERNEL.launches
    y.sum().backward()
    assert cv.DW_KERNEL.launches == n_dw and x.grad is not None
