"""Multi-head attention over pre-projected (B, S, D) tensors.

Port of comat_tpu/ops/attention.py (`multi_head_attention`). A CUDA
tensor attending over more than 128 keys goes to the flash-attention
kernels (`flash_attention_diff`: the forward kernel, and the two backward
kernels where autograd records); everything else, every CPU tensor
included, takes the plain path of the JAX `_attention_xla`: fp32 logits
and softmax, then the probabilities in v's dtype times v.

`capture_probs=True` also returns the fp32 probabilities (B, H, Sq, Skv)
that the plain path computes, for the attribute-concentration losses; a
call with capture never takes the flash kernel, which keeps no
probabilities.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from comat_tpu_torch.ops.flash_attention import flash_attention_diff

# Attention over at most this many keys stays on the plain path (the
# cross-attention over 77 text tokens, the 8x8 mid block), as in JAX.
PLAIN_MAX_KEYS = 128


def _plain_with_probs(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, S, d) attention with the softmax in fp32; returns the output
    and the fp32 probabilities."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v), probs


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
) -> torch.Tensor:
    """(B, H, S, d) attention with the softmax in fp32."""
    return _plain_with_probs(q, k, v)[0]


def multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    capture_probs: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """q (B, Sq, D); k, v (B, Skv, D) with D = num_heads * head_dim.
    Returns (B, Sq, D), or with `capture_probs` (out, fp32 probabilities
    (B, num_heads, Sq, Skv)) from the plain path."""
    B, Sq, D = q.shape
    Skv = k.shape[1]
    head_dim = D // num_heads
    if head_dim * num_heads != D:
        raise ValueError(f"D={D} is not a multiple of num_heads={num_heads}")

    def split(x, s):
        return x.reshape(B, s, num_heads, head_dim).transpose(1, 2)

    qh, kh, vh = split(q, Sq), split(k, Skv), split(v, Skv)
    probs = None
    if q.is_cuda and Skv > PLAIN_MAX_KEYS and not capture_probs:
        out = flash_attention_diff(qh, kh, vh)
    else:
        out, probs = _plain_with_probs(qh, kh, vh)
    out = out.transpose(1, 2).reshape(B, Sq, D)
    return (out, probs) if capture_probs else out
