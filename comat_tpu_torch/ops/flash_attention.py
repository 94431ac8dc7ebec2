"""Flash-attention forward: the CUDA kernel `csrc/flash_fwd.cu` and its
plain PyTorch version.

Port of comat_tpu/ops/flash_attention.py (`_fwd` / `flash_attention`).
The kernel never materialises the (Sq, Skv) probabilities; the plain
version `flash_attention_ref` does, in fp32, and is what a CPU tensor
gets. Both scale q by 1/sqrt(d) rounded to the input dtype before the
product, as the JAX `_fwd` does, so bf16 results line up.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from comat_tpu_torch.ops._build import CudaKernel

MAX_HEAD_DIM = 512

KERNEL = CudaKernel(
    "flash_fwd", "comat_flash_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p],
)


def _scale(d: int, dtype: torch.dtype) -> float:
    """1/sqrt(d) rounded to `dtype` (JAX multiplies by
    `jnp.asarray(scale, q.dtype)`)."""
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=dtype))


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention over (B, H, S, d): materialised fp32 softmax.

    Returns (o in q's dtype, lse fp32 (B, H, Sq))."""
    scale = torch.tensor(_scale(q.shape[-1], q.dtype), dtype=q.dtype)
    qs = (q * scale).float()
    logits = torch.matmul(qs, k.float().transpose(-1, -2))
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    o = torch.matmul(p, v.float()).to(q.dtype)
    return o, lse


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, want_lse: bool = False,
):
    """softmax(q k^T / sqrt(d)) v over (B, H, S, d) tensors.

    q, k, v may be strided views (for instance the (B, S, H, d) head
    split of a projection) as long as the last dim is contiguous. A CPU
    tensor gets the plain version; a CUDA tensor launches the kernel or
    raises. Returns o (B, H, Sq, d), plus lse fp32 (B, H, Sq) when
    `want_lse`."""
    if q.device.type == "cpu":
        o, lse = flash_attention_ref(q, k, v)
        return (o, lse) if want_lse else o
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"flash_attention takes CPU or CUDA tensors on one device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
        k.dtype == q.dtype and v.dtype == q.dtype
    ):
        raise ValueError(
            f"flash_attention takes fp32 or bf16 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected (B, H, S, d) q, k, v, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, Sq, d = q.shape
    Skv = k.shape[2]
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds the kernel's {MAX_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a contiguous last dim")
    # output as (B, Sq, H, d): the caller's head merge is then a view
    o = torch.empty(B, Sq, H, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = (
        torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
        if want_lse else None
    )
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, o) for s in (t.stride(0), t.stride(2), t.stride(1))
    ])
    KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        int(q.dtype == torch.bfloat16), B, H, Sq, Skv, d, strides,
        _scale(d, q.dtype),
        shape=(B * H, Sq, Skv, d, str(q.dtype).replace("torch.", "")),
    )
    return (o, lse) if want_lse else o
