"""3x3 stride-1 SAME convolution (NHWC, no bias): the CUDA kernel
`csrc/conv3x3.cu` and its plain PyTorch version.

Port of comat_tpu/ops/conv3x3.py (`conv3x3_same`, forward). The plain
version `conv3x3_ref` is the nine-tap sum of (B*H*W, C) @ (C, Cout)
products with fp32 accumulation, as `_tap_matmuls` computes it, and is
what a CPU tensor gets.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from comat_tpu_torch.ops._build import CudaKernel

KERNEL = CudaKernel(
    "conv3x3", "comat_conv3x3_fwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)


def use_conv_kernel(x_shape, w_shape) -> bool:
    """Dispatch gate: the shape part of the JAX `use_pallas_conv` (square,
    8-aligned, at least 128 pixels a side and 128 channels in and out).
    x is (B, H, W, C); w is (3, 3, C, Cout)."""
    _, H, W, C = x_shape
    kh, kw, _, Cout = w_shape
    return (
        kh == 3 and kw == 3 and H == W and H % 8 == 0 and H >= 128
        and C >= 128 and Cout >= 128
    )


def conv3x3_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: x (B, H, W, C), w (3, 3, C, Cout) -> (B, H, W, Cout)
    in x's dtype, accumulated in fp32."""
    B, H, W, C = x.shape
    Cout = w.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(B * H * W, Cout, dtype=torch.float32, device=x.device)
    for di in range(3):
        for dj in range(3):
            tap = xp[:, di:di + H, dj:dj + W, :].reshape(B * H * W, C)
            acc += tap.float() @ w[di, dj].float()
    return acc.reshape(B, H, W, Cout).to(x.dtype)


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv of NHWC x (B, H, W, C) with w (3, 3, C, Cout).

    A CPU tensor gets the plain version; a CUDA tensor launches the
    kernel or raises. On CUDA, x and w must be contiguous (a
    channels_last NCHW tensor permuted to NHWC is), fp32 or bf16, and C a
    multiple of 8."""
    if x.device.type == "cpu":
        return conv3x3_ref(x, w)
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(
            f"conv3x3_same takes CPU or CUDA tensors on one device, got "
            f"{x.device}, {w.device}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError(
            f"conv3x3_same takes fp32 or bf16 x and w of one dtype, got "
            f"{x.dtype}, {w.dtype}"
        )
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(
            f"expected x (B, H, W, C) and w (3, 3, C, Cout), got "
            f"{tuple(x.shape)}, {tuple(w.shape)}"
        )
    B, H, W, C = x.shape
    Cout = w.shape[3]
    if C % 8 != 0:
        raise ValueError(f"conv3x3_same needs C % 8 == 0, got C={C}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3_same needs contiguous NHWC x and HWIO w")
    y = torch.empty(B, H, W, Cout, dtype=x.dtype, device=x.device)
    KERNEL.launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(),
        int(x.dtype == torch.bfloat16), B, H, W, C, Cout,
        shape=(B, H, W, C, Cout, str(x.dtype).replace("torch.", "")),
    )
    return y
