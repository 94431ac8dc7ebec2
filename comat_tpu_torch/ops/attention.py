"""Multi-head attention over pre-projected (B, S, D) tensors.

Port of comat_tpu/ops/attention.py (`multi_head_attention`, without
probability capture). A CUDA tensor attending over more than 128 keys
goes to the flash-attention kernels (`flash_attention_diff`: the forward
kernel, and the two backward kernels where autograd records); everything
else, every CPU tensor included, takes the plain path of the JAX
`_attention_xla`: fp32 logits and softmax, then the probabilities in v's
dtype times v.
"""

from __future__ import annotations

import torch

from comat_tpu_torch.ops.flash_attention import flash_attention_diff

# Attention over at most this many keys stays on the plain path (the
# cross-attention over 77 text tokens, the 8x8 mid block), as in JAX.
PLAIN_MAX_KEYS = 128


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
) -> torch.Tensor:
    """(B, H, S, d) attention with the softmax in fp32."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
) -> torch.Tensor:
    """q (B, Sq, D); k, v (B, Skv, D) with D = num_heads * head_dim.
    Returns (B, Sq, D)."""
    B, Sq, D = q.shape
    Skv = k.shape[1]
    head_dim = D // num_heads
    if head_dim * num_heads != D:
        raise ValueError(f"D={D} is not a multiple of num_heads={num_heads}")

    def split(x, s):
        return x.reshape(B, s, num_heads, head_dim).transpose(1, 2)

    qh, kh, vh = split(q, Sq), split(k, Skv), split(v, Skv)
    if q.is_cuda and Skv > PLAIN_MAX_KEYS:
        out = flash_attention_diff(qh, kh, vh)
    else:
        out = attention_plain(qh, kh, vh)
    return out.transpose(1, 2).reshape(B, Sq, D)
