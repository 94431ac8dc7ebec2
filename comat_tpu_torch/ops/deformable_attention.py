"""Multi-scale deformable attention (Deformable-DETR family).

Port of comat_tpu/ops/deformable_attention.py (`ms_deformable_attention`).
The JAX op is XLA gathers, outside any Pallas kernel; here it is
`F.grid_sample` with the same semantics: bilinear sampling at
align_corners=False pixel coordinates (px = loc * W - 0.5), zero padding
outside the map. Values are sampled in fp32 and the weighted sum over
levels and points is taken in fp32, as JAX does; the result comes back
in the values' dtype. Inference only (the grounding models are frozen).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def ms_deformable_attention(
    value: torch.Tensor,                         # (B, S_total, heads, dh)
    spatial_shapes: Sequence[Tuple[int, int]],   # [(H_l, W_l)]
    sampling_locations: torch.Tensor,            # (B, Nq, heads, L, P, 2) in [0, 1]
    attention_weights: torch.Tensor,             # (B, Nq, heads, L, P), softmaxed
) -> torch.Tensor:
    """Returns (B, Nq, heads * dh) in value's dtype."""
    B, S, Hn, Dh = value.shape
    _, Nq, _, L, P, _ = sampling_locations.shape
    if L != len(spatial_shapes) or sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(f"spatial shapes {list(spatial_shapes)} do not cover {S} "
                         f"values at {L} levels")
    out = torch.zeros((B * Hn, Dh, Nq), dtype=torch.float32, device=value.device)
    off = 0
    for l, (h, w) in enumerate(spatial_shapes):
        lvl = value[:, off:off + h * w].float()              # (B, hw, Hn, Dh)
        lvl = lvl.permute(0, 2, 3, 1).reshape(B * Hn, Dh, h, w)
        off += h * w
        # grid_sample's [-1, 1] grid at align_corners=False samples pixel
        # ((g + 1) * W - 1) / 2 = loc * W - 0.5 for g = 2 * loc - 1
        loc = sampling_locations[:, :, :, l].float()          # (B, Nq, Hn, P, 2)
        grid = (2.0 * loc - 1.0).permute(0, 2, 1, 3, 4).reshape(B * Hn, Nq, P, 2)
        sampled = F.grid_sample(lvl, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=False)          # (B*Hn, Dh, Nq, P)
        wgt = attention_weights[:, :, :, l].float().permute(0, 2, 1, 3)
        out = out + (sampled * wgt.reshape(B * Hn, 1, Nq, P)).sum(-1)
    out = out.reshape(B, Hn, Dh, Nq).permute(0, 3, 1, 2)
    return out.reshape(B, Nq, Hn * Dh).to(value.dtype)
