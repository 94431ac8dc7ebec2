"""W8A8 kernels of pass 1 (--pass1_int8): the CUDA kernels
`csrc/quant_s8.cu` (the dynamic int8 quantize, and the int32 -> float
dequantize with bias) and `csrc/conv_s8.cu` (the int8 implicit-GEMM conv
with the dequantize in its epilogue), and their plain PyTorch versions.

No Pallas counterpart: JAX computes W8A8 through XLA
(comat_tpu/models/quant.py `_quant_dynamic`, `_weight_quant`,
`_dequant_bias`, `QDense`'s `lax.dot_general` and `QConv`'s
`lax.conv_general_dilated`, both with int32 sums). The arithmetic here is
JAX's to the bit: scale = max(absmax, 1e-12) / 127 in fp32, codes
clip(round(x / scale), -127, 127) dividing (round half to even), the
dequantize (float(acc) * s_x) * w_scale + bias in fp32, then one rounding
to the layer's dtype. The linear layers' int8 product is a library call,
`torch._int_mm` (an XLA matmul outside any kernel in JAX), between the
quantize and the dequantize kernels.

A CPU tensor gets the plain version (the conv's int32 sums as `F.conv2d`
in float64 on the codes, exact: |sum| <= 127^2 * 9 * 2560 < 2^53); a
CUDA tensor launches the kernel or raises.

Under tensor parallelism (`parallel.tp`) a row-parallel linear layer holds
a block of each token's features: `quantize(..., group=)` takes each
group's absmax over the ranks (an all-reduce MAX between the kernel's two
passes), `int8_linear(..., group=)` sums the ranks' int32 products (an
all-reduce SUM, exact) before the dequantize, so the codes, the sums and
the output are the unsharded layer's, bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from comat_tpu_torch.ops._build import CudaKernel

EPS = 1e-12

QUANT_KERNEL = CudaKernel(
    "quant_s8", "comat_quant_s8",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p],
)
DEQUANT_KERNEL = CudaKernel(
    "quant_s8", "comat_dequant_s8",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
)
CONV_KERNEL = CudaKernel(
    "conv_s8", "comat_conv_s8",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
)
KERNELS = (QUANT_KERNEL, DEQUANT_KERNEL, CONV_KERNEL)
# the conv kernel's output kinds (`out_kind`)
_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def quantize_ref(x: torch.Tensor, groups: int,
                 group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `quantize`. The divisor 127 is a tensor on x's
    device: PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, one rounding more than JAX's division."""
    xf = x.float().reshape(groups, -1)
    amax = xf.abs().amax(dim=1, keepdim=True)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    s = amax.clamp_min(EPS) / torch.full((), 127.0, device=x.device)
    q = torch.round(xf / s).clamp(-127, 127).to(torch.int8)
    return q.reshape(x.shape), s.reshape(groups)


def quantize(x: torch.Tensor, groups: int, role: str = "act",
             group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric dynamic int8 codes of x (contiguous, fp32 or bf16), one
    scale a group: x viewed as (groups, n), n = x.numel() // groups (a
    linear's tokens: groups = rows; a conv's samples: groups = B; a
    weight's output channels: groups = Cout). Returns (codes int8 of x's
    shape, scales fp32 (groups,)). `role` ("act" or "weight") only labels
    the launch in `QUANT_KERNEL.launches_by_shape`. With `group` (a process
    group whose ranks each hold a block of every group's values) the
    absmax is the group's over all ranks: two launches, the absmax and the
    codes, with a MAX all-reduce between."""
    if x.device.type == "cpu":
        return quantize_ref(x, groups, group)
    if not x.is_cuda or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quantize takes fp32 or bf16 CPU or CUDA tensors, got "
                         f"{x.dtype} on {x.device}")
    if not x.is_contiguous() or groups <= 0 or x.numel() % groups:
        raise ValueError(f"quantize needs a contiguous tensor of groups x n values, got "
                         f"{tuple(x.shape)} in {groups} groups")
    n = x.numel() // groups
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(groups, dtype=torch.float32, device=x.device)
    # the absmax's float bits: non-negative floats order as their bits
    amax = torch.empty(groups, dtype=torch.int32, device=x.device)
    args = (x.data_ptr(), int(x.dtype == torch.bfloat16), groups, n, q.data_ptr(),
            s.data_ptr(), amax.data_ptr())
    key = (groups, n, _dtype_name(x.dtype), role)
    if group is None:
        QUANT_KERNEL.launch(*args, 0, shape=key)
    else:
        QUANT_KERNEL.launch(*args, 1, shape=key)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        QUANT_KERNEL.launch(*args, 2, shape=key)
    return q, s


def dequant_ref(acc: torch.Tensor, sx: torch.Tensor, rows_per_scale: int,
                ws: torch.Tensor, bias: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
    """Plain version of `dequant`."""
    rows = sx.repeat_interleave(rows_per_scale)[:, None]
    y = acc.float() * rows * ws
    if bias is not None:
        y = y + bias
    return y.to(dtype)


def dequant(acc: torch.Tensor, sx: torch.Tensor, rows_per_scale: int, ws: torch.Tensor,
            bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """(float(acc) * sx[m // rows_per_scale]) * ws[n] (+ bias[n]) in fp32,
    then `dtype` (fp32 or bf16): acc (M, N) int32, sx (M // rows_per_scale,),
    ws and bias (N,) fp32 (bias may be None)."""
    if acc.device.type == "cpu":
        return dequant_ref(acc, sx, rows_per_scale, ws, bias, dtype)
    M, N = acc.shape
    tensors = [acc, sx, ws] + ([] if bias is None else [bias])
    if (acc.dtype != torch.int32 or any(t.dtype != torch.float32 for t in tensors[1:])
            or dtype not in (torch.float32, torch.bfloat16)
            or not all(t.is_cuda and t.is_contiguous() for t in tensors)
            or sx.numel() * rows_per_scale != M or ws.numel() != N
            or (bias is not None and bias.numel() != N)):
        raise ValueError("dequant takes contiguous CUDA acc (M, N) int32, sx "
                         "(M / rows_per_scale,), ws and bias (N,) fp32, into fp32 or bf16")
    out = torch.empty(M, N, dtype=dtype, device=acc.device)
    DEQUANT_KERNEL.launch(
        acc.data_ptr(), sx.data_ptr(), rows_per_scale, ws.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        int(dtype == torch.bfloat16), M, N,
        shape=(M, N, _dtype_name(dtype)),
    )
    return out


def int8_linear(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                bias: Optional[torch.Tensor], dtype: torch.dtype,
                group=None) -> torch.Tensor:
    """JAX's int8 `QDense`: x (..., K) quantized per token, the int32
    product with the codes wq (N, K) by `torch._int_mm`, dequantized with
    the weight scales ws (N,) and the fp32 bias (N,) into `dtype`. On CUDA
    `torch._int_mm` asks M > 16 and K, N multiples of 8. With `group` x and
    wq hold this rank's block of the K features (a row-parallel layer): the
    tokens' absmax and the int32 sums are taken over the group's ranks, the
    bias added once."""
    K, N = x.shape[-1], wq.shape[0]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    if x.is_cuda and (M <= 16 or K % 8 or N % 8):
        raise ValueError(f"int8_linear on CUDA needs M > 16 and K, N % 8 == 0, got "
                         f"M={M}, K={K}, N={N}")
    xq, sx = quantize(x2, M) if group is None else quantize(x2, M, group=group)
    acc = torch._int_mm(xq, wq.t())
    if group is not None:
        dist.all_reduce(acc, group=group)
    return dequant(acc, sx, 1, ws, bias, dtype).reshape(*x.shape[:-1], N)


def conv_s8_ref(xq: torch.Tensor, wq: torch.Tensor, ks: int, stride: int,
                pad: int) -> torch.Tensor:
    """Plain int32 sums of the int8 conv: xq (B, H, W, C) and wq (Cout,
    ks*ks*C) codes -> (B, Ho, Wo, Cout) int32, exact through float64."""
    Cout, C = wq.shape[0], xq.shape[-1]
    w = wq.reshape(Cout, ks, ks, C).permute(0, 3, 1, 2).double()
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), w, stride=stride, padding=pad)
    return torch.round(y).to(torch.int32).permute(0, 2, 3, 1).contiguous()


def conv_s8(xq: torch.Tensor, wq: torch.Tensor, ks: int, stride: int, pad: int,
            out_dtype: torch.dtype, sx: Optional[torch.Tensor] = None,
            ws: Optional[torch.Tensor] = None,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 conv of NHWC codes xq (B, H, W, C) with the codes wq (Cout,
    ks*ks*C), (dy, dx, c) order: `out_dtype` int32 gives the sums, fp32 or
    bf16 the dequantize (float(acc) * sx[b]) * ws[n] (+ bias[n]), sx (B,),
    ws and bias (Cout,) fp32. Returns (B, Ho, Wo, Cout). On CUDA, C % 64 ==
    0 and contiguous tensors."""
    if out_dtype not in _OUT_KIND or (out_dtype != torch.int32 and (sx is None or ws is None)):
        raise ValueError(f"conv_s8 writes int32 sums, or fp32 / bf16 with sx and ws, "
                         f"not {out_dtype}")
    B, H, W, C = xq.shape
    Cout = wq.shape[0]
    if xq.device.type == "cpu":
        acc = conv_s8_ref(xq, wq, ks, stride, pad)
        if out_dtype == torch.int32:
            return acc
        Ho, Wo = acc.shape[1:3]
        return dequant_ref(acc.reshape(-1, Cout), sx, Ho * Wo, ws, bias,
                           out_dtype).reshape(acc.shape)
    tensors = [xq, wq] + [t for t in (sx, ws, bias) if t is not None]
    if (xq.dtype != torch.int8 or wq.dtype != torch.int8 or wq.shape[1] != ks * ks * C
            or C % 64 or not all(t.is_cuda and t.is_contiguous() for t in tensors)):
        raise ValueError(f"conv_s8 takes contiguous CUDA int8 codes x (B, H, W, C) with "
                         f"C % 64 == 0 and w (Cout, ks*ks*C), got {tuple(xq.shape)}, "
                         f"{tuple(wq.shape)}, ks {ks}")
    Ho = (H + 2 * pad - ks) // stride + 1
    Wo = (W + 2 * pad - ks) // stride + 1
    out = torch.empty(B, Ho, Wo, Cout, dtype=out_dtype, device=xq.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    CONV_KERNEL.launch(
        xq.data_ptr(), wq.data_ptr(), out.data_ptr(), ptr(sx), ptr(ws), ptr(bias),
        _OUT_KIND[out_dtype], B, H, W, C, Cout, ks, stride, pad,
        shape=(B, H, W, C, Cout, ks, stride, _dtype_name(out_dtype)),
    )
    return out


def int8_conv(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
              bias: Optional[torch.Tensor], ks: int, stride: int, pad: int,
              dtype: torch.dtype) -> torch.Tensor:
    """JAX's int8 `QConv`: x (B, C, H, W), best channels_last, quantized per
    sample over (C, H, W), the int8 conv and its dequantize with the weight
    codes wq (Cout, ks*ks*C), scales ws (Cout,) and fp32 bias into `dtype`.
    Returns (B, Cout, Ho, Wo) in channels_last memory."""
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()
    xq, sx = quantize(x_nhwc, x.shape[0])
    return conv_s8(xq, wq, ks, stride, pad, dtype, sx, ws, bias).permute(0, 3, 1, 2)
