"""3x3 stride-1 SAME convolution (NHWC, no bias), forward and backward:
the CUDA kernels `csrc/conv3x3.cu` (forward, and dx) and
`csrc/conv3x3_dw.cu` (dw), and their plain PyTorch versions.

Port of comat_tpu/ops/conv3x3.py (`conv3x3_same` with its `_vjp_fwd` /
`_vjp_bwd`). The plain version `conv3x3_ref` is the nine-tap sum of
(B*H*W, C) @ (C, Cout) products with fp32 accumulation, as `_tap_matmuls`
computes it; `conv3x3_dw_ref` the nine x_tap^T @ dy sums of
`_conv_dw_kernel`. They are what a CPU tensor gets. dx is the forward
kernel on dy with the spatially flipped, io-transposed weights, as
`_vjp_bwd` computes it; dw runs only when the weight needs a gradient.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from comat_tpu_torch.ops._build import CudaKernel

KERNEL = CudaKernel(
    "conv3x3", "comat_conv3x3_fwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
DW_KERNEL = CudaKernel(
    "conv3x3_dw", "comat_conv3x3_dw",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong,
                                                   ctypes.c_void_p],
)

# fp32 dw splits the pixel sum so that about this many blocks fill the
# card (two per SM of an H100), each summing at least DW_MIN_PIXELS pixels.
DW_TARGET_BLOCKS = 264
DW_MIN_PIXELS = 2048
# bf16 dw: one block per SM (DW_SMS on an H100), an output tile of 128 x
# 256 products (`dw_tiles`), a pixel step of one image row by 64 columns.
# Its split count weighs the
# steps a block runs (at DW_SM_FLOPS a block) by the waves of DW_SMS
# blocks, against the fp32 workspace it writes and reads back (at
# DW_HBM_BYTES).
DW_SMS = 132
DW_SM_FLOPS = 5e12
DW_HBM_BYTES = 3.35e12
DW_MAX_SPLITS = 512


def use_conv_kernel(x_shape, w_shape) -> bool:
    """Dispatch gate: the shape part of the JAX `use_pallas_conv` (square,
    8-aligned, at least 128 pixels a side and 128 channels in and out),
    applied in both directions as that gate is: the kernel takes C % 8 ==
    0, so both C (forward) and Cout (dx, Cout -> C) must be multiples of
    8. x is (B, H, W, C); w is (3, 3, C, Cout)."""
    _, H, W, C = x_shape
    kh, kw, _, Cout = w_shape
    return (
        kh == 3 and kw == 3 and H == W and H % 8 == 0 and H >= 128
        and C >= 128 and Cout >= 128 and C % 8 == 0 and Cout % 8 == 0
    )


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


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


def flip_io(w: torch.Tensor) -> torch.Tensor:
    """The dx weights of `_vjp_bwd`: w rotated 180 degrees in space, in
    and out channels swapped: (3, 3, C, Cout) -> (3, 3, Cout, C)."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def conv3x3_dw_ref(x: torch.Tensor, dy: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """Plain dw: x (B, H, W, C), dy (B, H, W, Cout) -> (3, 3, C, Cout),
    the nine x_tap^T @ dy sums in fp32, cast to `dtype`."""
    B, H, W, C = x.shape
    Cout = dy.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    g = dy.reshape(B * H * W, Cout).float()
    dw = torch.empty(3, 3, C, Cout, dtype=torch.float32, device=x.device)
    for di in range(3):
        for dj in range(3):
            tap = xp[:, di:di + H, dj:dj + W, :].reshape(B * H * W, C)
            dw[di, dj] = tap.float().T @ g
    return dw.to(dtype)


def _check(x: torch.Tensor, w: torch.Tensor, name: str) -> None:
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(
            f"{name} takes CPU or CUDA tensors on one device, got "
            f"{x.device}, {w.device}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError(
            f"{name} takes fp32 or bf16 tensors of one dtype, got "
            f"{x.dtype}, {w.dtype}"
        )
    if x.shape[-1] % 8 != 0:
        raise ValueError(f"{name} needs C % 8 == 0, got C={x.shape[-1]}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name} needs contiguous NHWC tensors")
    if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError(f"{name} reads bf16 through TMA: 16-byte aligned tensors")


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor, role: str = "fwd") -> torch.Tensor:
    """3x3 SAME conv of NHWC x (B, H, W, C) with w (3, 3, C, Cout),
    without a gradient (see `conv3x3_same`).

    A CPU tensor gets the plain version; a CUDA tensor launches the
    kernel or raises. On CUDA, x and w must be contiguous (a
    channels_last NCHW tensor permuted to NHWC is), fp32 or bf16, and C a
    multiple of 8. `role` ("fwd", or "dx" from the backward) only labels
    the launch in `KERNEL.launches_by_shape`. The bf16 kernel reads w
    through a TMA tensor map, whose row stride must be a multiple of 16
    bytes: a bf16 Cout that is not a multiple of 8 is zero-padded in w and
    sliced off y."""
    if x.device.type == "cpu":
        return conv3x3_ref(x, w)
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(
            f"expected x (B, H, W, C) and w (3, 3, C, Cout), got "
            f"{tuple(x.shape)}, {tuple(w.shape)}"
        )
    _check(x, w, "conv3x3")
    B, H, W, C = x.shape
    Cout = w.shape[3]
    if x.dtype == torch.bfloat16 and Cout % 8:
        y = conv3x3_fwd(x, F.pad(w, (0, -Cout % 8)), role)
        return y[..., :Cout].contiguous()
    y = torch.empty(B, H, W, Cout, dtype=x.dtype, device=x.device)
    KERNEL.launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(),
        int(x.dtype == torch.bfloat16), B, H, W, C, Cout,
        shape=(B, H, W, C, Cout, _dtype_name(x.dtype), role),
    )
    return y


def dw_tiles(C: int, Cout: int):
    """(blocks a pixel split, (tap, channel) rows, output channels of a
    block) of the bf16 dw kernel. The rows are row boxes of 64 channels of
    one tap, 9 * ceil(C / 64) of them over the 9 taps. Where Cout % 256 ==
    0 a block takes 2 boxes by 256 output channels, else 4 boxes by 128
    output channels."""
    boxes = 9 * math.ceil(C / 64)
    if Cout % 256 == 0:
        return math.ceil(boxes / 2) * (Cout // 256), 128, 256
    return math.ceil(boxes / 4) * math.ceil(Cout / 128), 256, 128


@functools.lru_cache(maxsize=None)
def dw_splits(B: int, H: int, W: int, C: int, Cout: int, bf16: bool):
    """(splits, units per split) of the dw kernel's pixel sum: pixels in
    fp32; in bf16 steps of one image row by 64 columns, B*H*ceil(W/64) in
    all, with the split count of the least modelled time (a search of
    hundreds of candidates, so cached: it runs on the host before every
    launch)."""
    if not bf16:
        M = B * H * W
        tiles = math.ceil(9 * C / 128) * math.ceil(Cout / 128)
        splits = max(1, min(math.ceil(DW_TARGET_BLOCKS / tiles), M // DW_MIN_PIXELS))
        per = math.ceil(M / splits / 8) * 8
        return math.ceil(M / per), per
    tiles, rows, cols = dw_tiles(C, Cout)
    steps = B * H * math.ceil(W / 64)
    step_s = 2 * 64 * rows * cols / DW_SM_FLOPS
    best = None
    for want in range(1, min(steps, DW_MAX_SPLITS) + 1):
        per = math.ceil(steps / want)
        splits = math.ceil(steps / per)
        cost = (math.ceil(tiles * splits / DW_SMS) * per * step_s
                + 8 * splits * 9 * C * Cout / DW_HBM_BYTES)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1:]


def conv3x3_dw(x: torch.Tensor, dy: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """dw (3, 3, C, Cout) in `dtype` of the 3x3 SAME conv of x (B, H, W,
    C) for the output gradient dy (B, H, W, Cout). A CPU tensor gets the
    plain version; a CUDA tensor launches the dw kernel (x, dy contiguous,
    one of fp32 or bf16, C a multiple of 8) or raises. The bf16 kernel
    reads x and dy through TMA tensor maps (16-byte aligned rows): a bf16
    Cout that is not a multiple of 8 is zero-padded in dy and sliced off
    dw."""
    if x.device.type == "cpu":
        return conv3x3_dw_ref(x, dy, dtype)
    if x.dim() != 4 or dy.shape[:3] != x.shape[:3]:
        raise ValueError(
            f"expected x (B, H, W, C) and dy (B, H, W, Cout), got "
            f"{tuple(x.shape)}, {tuple(dy.shape)}"
        )
    _check(x, dy, "conv3x3_dw")
    if dtype != x.dtype:
        raise ValueError(f"conv3x3_dw writes dw in x's dtype {x.dtype}, not {dtype}")
    B, H, W, C = x.shape
    Cout = dy.shape[3]
    bf16 = x.dtype == torch.bfloat16
    if bf16 and Cout % 8:
        return conv3x3_dw(x, F.pad(dy, (0, -Cout % 8)), dtype)[..., :Cout].contiguous()
    splits, per = dw_splits(B, H, W, C, Cout, bf16)
    dw = torch.empty(3, 3, C, Cout, dtype=x.dtype, device=x.device)
    work = torch.empty(splits, 9 * C * Cout, dtype=torch.float32, device=x.device)
    DW_KERNEL.launch(
        x.data_ptr(), dy.data_ptr(), dw.data_ptr(), work.data_ptr(),
        int(bf16), B, H, W, C, Cout, splits, per,
        shape=(B, H, W, C, Cout, _dtype_name(x.dtype)),
    )
    return dw


class _Conv3x3(torch.autograd.Function):
    """dx = the forward conv of dy with `flip_io(w)`; dw only where the
    weight needs a gradient (a frozen VAE skips it, as XLA drops it in
    JAX, and x is then not kept for the backward)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x if w.requires_grad else None, w)
        return conv3x3_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(w.dtype).contiguous()
        dx = conv3x3_fwd(dy, flip_io(w), "dx") if ctx.needs_input_grad[0] else None
        dw = conv3x3_dw(x, dy, w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`conv3x3_fwd` with a gradient, through the backward above. Where
    autograd does not record (no_grad, or neither x nor w requires grad)
    the Function keeps nothing and this is `conv3x3_fwd` itself."""
    return _Conv3x3.apply(x, w)
