"""Layers of the segmentation models: fp32 parameters, a compute dtype.

Flax keeps a layer's parameters in fp32 and casts them, with the input,
to the layer's `dtype` where it computes. These layers do the same, so
that one fp32 state dict serves the fp32 and the bf16 model: `dtype` is
the compute dtype (bf16 on the card for the released geometries, fp32
for the tiny ones and for the heads JAX keeps in fp32). Norms take their
statistics in fp32 and return the compute dtype. Parameter names are
torch's (`weight`, `bias`), so checkpoints load with `load_state_dict`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Dense(nn.Linear):
    """nn.Linear computing in `dtype` (flax `nn.Dense(dtype=...)`)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(d_in, d_out, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    """nn.Conv2d (NCHW) computing in `dtype`."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(c_in, c_out, k, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), _cast(self.bias, dt),
                        self.stride, self.padding)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, statistics in fp32."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over NCHW, statistics in fp32."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__(groups, channels, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


class Embedding(nn.Embedding):
    """Rows of an fp32 table, cast to `dtype`."""

    def __init__(self, n: int, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(n, dim)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.weight).to(self.compute_dtype)


class BatchNorm2d(nn.Module):
    """Inference BatchNorm over NCHW on running statistics (ultralytics'
    names: weight, bias, running_mean, running_var)."""

    def __init__(self, channels: int, eps: float = 1e-3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(x - mean) * (weight * rsqrt(var + eps)) + bias, as flax's
        BatchNorm normalises; the factor is formed in fp32."""
        dt = self.compute_dtype
        mul = (self.weight * torch.rsqrt(self.running_var + self.eps)).to(dt)
        c = lambda t: t.to(dt)[:, None, None]  # noqa: E731
        return (x.to(dt) - c(self.running_mean)) * mul[:, None, None] + c(self.bias)


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d), masked) v over (..., S, d), as the JAX
    modules' einsums: logits and softmax in fp32, the weights cast to v's
    dtype for the second product. `key_mask` (broadcast to the logits)
    keeps where True; the rest get -1e30."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (q.shape[-1] ** 0.5)
    if key_mask is not None:
        logits = torch.where(key_mask, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    return torch.matmul(p.to(v.dtype), v)
