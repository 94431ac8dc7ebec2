"""The W8A8 kernels (`csrc/quant_s8.cu`, `csrc/conv_s8.cu`) against their
plain PyTorch versions, on the card: the quantize's codes and scales, the
dequantize, the int8 conv's int32 sums and its dequantizing epilogue, all
bit for bit (the plain versions do the same IEEE operations in the same
order; int32 sums are exact), and the int8 linear and conv layers on the
card against the same layers on the CPU, bit for bit.

These tests need an NVIDIA card and skip without one. The file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_quant_cuda.py
"""

import pytest
import torch

from comat_tpu_torch.ops import quant as tq


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _planted(x):
    """Put values on .5 boundaries of the code grid: row absmax 127 * 2^-k."""
    flat = x.view(x.shape[0], -1)
    s = 2.0 ** -torch.arange(flat.shape[0], device=x.device).remainder(3).float()
    flat[:, 0] = 127 * s
    flat[:, 1:5] = s[:, None] * torch.tensor([0.5, -1.5, 2.5, 126.5], device=x.device)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [
    ((616, 768), 616), ((4096, 320), 4096), ((8, 64, 64, 320), 8), ((12, 32, 32, 1280), 12),
    ((3, 5000), 3), ((320, 3, 3, 960), 320)])
def test_quantize_kernel_equals_plain(card, dtype, shape, groups):
    x = _planted(torch.randn(shape, generator=card, device="cuda") * 3).to(dtype)
    before = tq.QUANT_KERNEL.launches
    q, s = tq.quantize(x, groups)
    assert tq.QUANT_KERNEL.launches == before + 1
    q_ref, s_ref = tq.quantize_ref(x, groups)
    assert q.dtype == torch.int8 and q.shape == x.shape and s.shape == (groups,)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_dequant_kernel_equals_plain(card, dtype, bias):
    M, N = 1000, 640
    acc = torch.randint(-2 ** 28, 2 ** 28, (M, N), generator=card, device="cuda",
                        dtype=torch.int32)
    sx = torch.rand(M // 4, generator=card, device="cuda") / 127
    ws = torch.rand(N, generator=card, device="cuda") / 127
    b = torch.randn(N, generator=card, device="cuda") if bias else None
    got = tq.dequant(acc, sx, 4, ws, b, dtype)
    assert torch.equal(got, tq.dequant_ref(acc, sx, 4, ws, b, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.int32, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # (B, H, C, Cout, ks, stride, pad); ragged M and Cout tiles (128 x 128)
    (2, 16, 64, 128, 3, 1, 1), (2, 16, 128, 64, 3, 2, 1), (2, 16, 192, 320, 1, 1, 0),
    (1, 13, 64, 200, 3, 1, 1), (3, 9, 128, 72, 3, 2, 1), (1, 8, 2560, 1280, 3, 1, 1)])
def test_conv_kernel_equals_plain(card, out_dtype, shape):
    B, H, C, Cout, ks, stride, pad = shape
    xq = torch.randint(-127, 128, (B, H, H, C), generator=card, device="cuda").to(torch.int8)
    wq = torch.randint(-127, 128, (Cout, ks * ks * C), generator=card,
                       device="cuda").to(torch.int8)
    sx = torch.rand(B, generator=card, device="cuda") / 127
    ws = torch.rand(Cout, generator=card, device="cuda") / 127
    bias = torch.randn(Cout, generator=card, device="cuda")
    before = tq.CONV_KERNEL.launches
    got = tq.conv_s8(xq, wq, ks, stride, pad, out_dtype, sx, ws, bias)
    assert tq.CONV_KERNEL.launches == before + 1
    acc = tq.conv_s8_ref(xq, wq, ks, stride, pad)
    if out_dtype == torch.int32:
        want = acc
    else:
        Ho, Wo = acc.shape[1:3]
        want = tq.dequant_ref(acc.reshape(-1, Cout), sx, Ho * Wo, ws, bias,
                              out_dtype).reshape(acc.shape)
    assert got.dtype == out_dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_layers_on_the_card_equal_the_cpu(card, dtype):
    x = torch.randn(2, 320, 16, 16, generator=card, device="cuda").to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    wq = torch.randint(-127, 128, (640, 9 * 320), generator=card, device="cuda").to(torch.int8)
    ws = torch.rand(640, generator=card, device="cuda") / 127
    bias = torch.randn(640, generator=card, device="cuda")
    got = tq.int8_conv(x, wq, ws, bias, 3, 2, 1, dtype)
    want = tq.int8_conv(x.cpu(), wq.cpu(), ws.cpu(), bias.cpu(), 3, 2, 1, dtype)
    assert got.shape == (2, 640, 8, 8) and torch.equal(got.cpu(), want)
    t = torch.randn(2, 77, 768, generator=card, device="cuda").to(dtype)
    wl = torch.randint(-127, 128, (320, 768), generator=card, device="cuda").to(torch.int8)
    got = tq.int8_linear(t, wl, ws[:320].contiguous(), None, dtype)
    want = tq.int8_linear(t.cpu(), wl.cpu(), ws[:320].cpu(), None, dtype)
    assert got.shape == (2, 77, 320) and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    xq = torch.zeros(1, 8, 8, 40, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="C % 64"):
        tq.conv_s8(xq, torch.zeros(8, 9 * 40, dtype=torch.int8, device="cuda"), 3, 1, 1,
                   torch.int32)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        tq.quantize(torch.zeros(4, 8, dtype=torch.float16, device="cuda"), 4)
    with pytest.raises(ValueError, match="M > 16"):
        tq.int8_linear(torch.zeros(4, 64, device="cuda"),
                       torch.zeros(8, 64, dtype=torch.int8, device="cuda"),
                       torch.ones(8, device="cuda"), None, torch.float32)
