"""Flash attention, forward and backward: the CUDA kernels
`csrc/flash_fwd.cu` (forward) and `csrc/flash_bwd.cu` (dq; dk and dv) and
their plain PyTorch versions.

Port of comat_tpu/ops/flash_attention.py (`_fwd` / `flash_attention` and
`flash_attention_diff` with its `_flash_diff_fwd` / `_flash_diff_bwd`
VJP). The kernels never materialise the (Sq, Skv) probabilities; the plain
versions `flash_attention_ref` and `flash_attention_bwd_ref` do, with
fp32 sums, and are what a CPU tensor gets. All scale q by 1/sqrt(d)
rounded to the input dtype before the product, as the JAX `_fwd` does,
and round where the JAX kernels round (the forward's P to v's dtype,
with the denominator summed from the rounded P; the backward's dS to k's
and q's dtype, P to dO's), so bf16 results line up.
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
DQ_KERNEL = CudaKernel(
    "flash_bwd", "comat_flash_bwd_dq",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float,
       ctypes.c_void_p],
)
DKV_KERNEL = CudaKernel(
    "flash_bwd", "comat_flash_bwd_dkv",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p],
)


def _scale(d: int, dtype: torch.dtype) -> float:
    """1/sqrt(d) rounded to `dtype` (JAX multiplies by
    `jnp.asarray(scale, q.dtype)`)."""
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=dtype))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _bhsd_strides(*tensors):
    """(batch, seq, head) element strides of (B, H, S, d) tensors."""
    return [s for t in tensors for s in (t.stride(0), t.stride(2), t.stride(1))]


def _empty_bhsd(B, H, S, d, like: torch.Tensor) -> torch.Tensor:
    """(B, H, S, d) laid out as (B, S, H, d): the head merge is a view."""
    return torch.empty(B, S, H, d, dtype=like.dtype, device=like.device).transpose(1, 2)


def _check(q, k, v) -> None:
    """What the kernels take: (B, H, S, d) fp32 or bf16 CUDA tensors of one
    dtype with a contiguous last dim and d <= 512."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"flash attention takes CPU or CUDA tensors on one device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
        k.dtype == q.dtype and v.dtype == q.dtype
    ):
        raise ValueError(
            f"flash attention takes fp32 or bf16 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected (B, H, S, d) q, k, v, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, _, d = q.shape
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds the kernel's {MAX_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash attention needs a contiguous last dim")


def _tma_ok(t: torch.Tensor) -> bool:
    """What the bf16 kernels' TMA tensor maps take: d % 8 == 0, a 16-byte
    aligned tensor, and (batch, seq, head) strides that are multiples of
    8 elements (16 bytes) wherever the dim has extent > 1."""
    return not (t.shape[-1] % 8 or t.data_ptr() % 16 or any(
        t.stride(i) % 8 for i in range(3) if t.shape[i] > 1
    ))


def _check_tma(*tensors) -> None:
    for t in tensors:
        if not _tma_ok(t):
            raise ValueError(
                f"the bf16 flash kernels read through TMA: d % 8 == 0, 16-byte "
                f"alignment and strides in multiples of 8, got shape "
                f"{tuple(t.shape)} strides {t.stride()}"
            )


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention over (B, H, S, d): materialised fp32 softmax.

    Rounds where the JAX kernel rounds: the probabilities exp(logits - m)
    go to v's dtype before P*V, and the denominator is the fp32 sum of the
    rounded values (the kernel's ones column appended to V); a no-op in
    fp32. Returns (o in q's dtype, lse fp32 (B, H, Sq))."""
    scale = torch.tensor(_scale(q.shape[-1], q.dtype), dtype=q.dtype)
    qs = (q * scale).float()
    logits = torch.matmul(qs, k.float().transpose(-1, -2))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m).to(v.dtype).float()
    l = p.sum(dim=-1, keepdim=True)
    o = (torch.matmul(p, v.float()) / l).to(q.dtype)
    return o, (m + torch.log(l)).squeeze(-1)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, want_lse: bool = False,
):
    """softmax(q k^T / sqrt(d)) v over (B, H, S, d) tensors, without a
    gradient (see `flash_attention_diff`).

    q, k, v may be strided views (for instance the (B, S, H, d) head
    split of a projection) as long as the last dim is contiguous. A CPU
    tensor gets the plain version; a CUDA tensor launches the kernel or
    raises. Returns o (B, H, Sq, d), plus lse fp32 (B, H, Sq) when
    `want_lse`."""
    if q.device.type == "cpu":
        o, lse = flash_attention_ref(q, k, v)
        return (o, lse) if want_lse else o
    _check(q, k, v)
    if q.dtype == torch.bfloat16:
        _check_tma(q, k, v)
    B, H, Sq, d = q.shape
    Skv = k.shape[2]
    o = _empty_bhsd(B, H, Sq, d, q)
    lse = (
        torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
        if want_lse else None
    )
    strides = (ctypes.c_longlong * 12)(*_bhsd_strides(q, k, v, o))
    KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        int(q.dtype == torch.bfloat16), B, H, Sq, Skv, d, strides,
        _scale(d, q.dtype),
        shape=(B * H, Sq, Skv, d, _dtype_name(q.dtype)),
    )
    return (o, lse) if want_lse else o


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the last two dims with fp32 sums and an fp32 result, as
    JAX's `dot_general(..., preferred_element_type=f32)`: bf16 operands on
    the card go through cuBLAS's bf16 GEMM (the tensor cores, fp32
    accumulation), anything else through an fp32 matmul."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, dvec: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward over (B, H, S, d): P recomputed from (q^, k, lse),
    dvec = rowsum(dO * o) fp32 (B, H, Sq). Returns (dq, dk, dv) in the
    input dtype, with the rounding points of the JAX kernels: each of the
    five products takes its operands in the input dtype and sums in fp32
    (`_mm32`)."""
    d = q.shape[-1]
    qs = q * torch.tensor(_scale(d, q.dtype), dtype=q.dtype)
    p = torch.exp(_mm32(qs, k.transpose(-1, -2)) - lse[..., None])
    dp = _mm32(do, v.transpose(-1, -2))
    ds = p * (dp - dvec[..., None])
    dq = _mm32(ds.to(k.dtype), k) * (1.0 / math.sqrt(d))
    dk = _mm32(ds.to(q.dtype).transpose(-1, -2), qs)
    dv = _mm32(p.to(do.dtype).transpose(-1, -2), do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_args(q, k, v, do, lse, dvec):
    """Check the backward's inputs; returns what both kernels read: (the q
    operand, qscale, do, lse, dvec). The kernels use q^ = q * qscale
    rounded to the dtype. In bf16 that product is formed here, once, and
    the kernels take q^ with qscale = 1 (JAX's `_fwd` hands its scaled
    `qf` to the backward likewise); a `do` whose layout breaks a TMA rule
    (autograd chooses it) is copied to the (B, S, H, d) layout."""
    _check(q, k, v)
    B, H, Sq, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(
            f"do must match q {tuple(q.shape)} {q.dtype}, got "
            f"{tuple(do.shape)} {do.dtype} on {do.device}"
        )
    for name, t in (("lse", lse), ("dvec", dvec)):
        if t.shape != (B, H, Sq) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be fp32 (B, H, Sq) on {q.device}")
    scale = _scale(d, q.dtype)
    if q.dtype == torch.bfloat16:
        _check_tma(k, v)
        if not _tma_ok(do):
            do = do.transpose(1, 2).contiguous().transpose(1, 2)
        q, scale = q * torch.tensor(scale, dtype=q.dtype), 1.0
    elif do.stride(-1) != 1:
        do = do.contiguous()
    return q, scale, do, lse.contiguous(), dvec.contiguous()


def _launch_dq(q, k, v, qk, qscale, do, lse, dvec) -> torch.Tensor:
    B, H, Sq, d = q.shape
    dq = _empty_bhsd(B, H, Sq, d, q)
    strides = (ctypes.c_longlong * 15)(*_bhsd_strides(qk, k, v, do, dq))
    DQ_KERNEL.launch(
        qk.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
        int(q.dtype == torch.bfloat16), B, H, Sq, k.shape[2], d, strides,
        qscale, 1.0 / math.sqrt(d),
        shape=(B * H, Sq, k.shape[2], d, _dtype_name(q.dtype)),
    )
    return dq


def _launch_dkv(q, k, v, qk, qscale, do, lse, dvec):
    B, H, Sq, d = q.shape
    Skv = k.shape[2]
    dk = _empty_bhsd(B, H, Skv, d, k)
    dv = _empty_bhsd(B, H, Skv, d, v)
    strides = (ctypes.c_longlong * 18)(*_bhsd_strides(qk, k, v, do, dk, dv))
    DKV_KERNEL.launch(
        qk.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        int(q.dtype == torch.bfloat16), B, H, Sq, Skv, d, strides, qscale,
        shape=(B * H, Sq, Skv, d, _dtype_name(q.dtype)),
    )
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, dvec) -> torch.Tensor:
    """dq of attention over (B, H, S, d) CUDA tensors for the output
    gradient `do`, from the forward's `lse` and dvec = rowsum(do * o),
    both fp32 (B, H, Sq): launches the dq kernel or raises. dq is laid out
    as (B, Sq, H, d)."""
    return _launch_dq(q, k, v, *_bwd_args(q, k, v, do, lse, dvec))


def flash_attention_bwd_dkv(q, k, v, do, lse, dvec):
    """(dk, dv) as `flash_attention_bwd_dq` gives dq: launches the dk/dv
    kernel or raises. dk and dv are laid out as (B, Skv, H, d)."""
    return _launch_dkv(q, k, v, *_bwd_args(q, k, v, do, lse, dvec))


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, dvec: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention over (B, H, S, d) tensors for the output
    gradient `do`, from the forward's `lse` and dvec = rowsum(do * o),
    both fp32 (B, H, Sq). A CPU tensor gets the plain version; a CUDA
    tensor launches the dq kernel and the dk/dv kernel, or raises."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, do, lse, dvec)
    args = _bwd_args(q, k, v, do, lse, dvec)
    return _launch_dq(q, k, v, *args), *_launch_dkv(q, k, v, *args)


class _FlashAttention(torch.autograd.Function):
    """Forward with the LSE saved; backward D = rowsum(dO * o) in fp32
    (outside the kernels, as `_flash_diff_bwd` computes it), then dq and
    dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention(q, k, v, want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dvec = (do.float() * o.float()).sum(-1)
        return flash_attention_bwd(q, k, v, do, lse, dvec)


def flash_attention_diff(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
) -> torch.Tensor:
    """`flash_attention` with a gradient: where autograd records (grad
    enabled and an input requires grad) the forward also writes the LSE
    and the backward runs `flash_attention_bwd`; elsewhere it is
    `flash_attention` itself."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    return flash_attention(q, k, v)
