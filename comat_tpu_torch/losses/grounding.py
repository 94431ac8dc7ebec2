"""Attribute-concentration grounding losses (token and pixel).

Port of comat_tpu/losses/grounding.py (`_bce_log`, `_resize_masks`,
`grounding_losses_for_layer`, `dedup_draw_weights`,
`comat_grounding_loss`). For one sample and one resolution, with L
captured cross-attention maps A_l (heads, HW, 77), per-word masks M_w
and the token groups T_w of the words:

  token_loss = sum_l sum_w [(1/|T_w|) sum_{t in T_w}
        (1 - mean_heads(sum(A[., t] * M_w) / sum(A[., t])))^2] / |W|
  pixel_loss = sum_w BCE(sum_{t in T_w} mean_{l, heads} A[., t], M_w) / |W|

summed over the captured segments and resolutions and divided by the
batch size. Words and tokens are padded to fixed (W, T) with validity
masks, and the token sums are contractions with one-hot selectors, as in
JAX.

The masks are resized with the port's own copy of JAX's
`jax.image.resize(..., "bilinear", antialias=True)` (a triangle filter
widened by the downscale factor, weights normalised per output pixel)
and binarized with `> 0`. `F.interpolate(..., antialias=True)` filters
differently at box edges, and `> 0` would turn that into flipped pixels.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from comat_tpu_torch import trace

_F32_TINY = float(np.finfo(np.float32).tiny)    # smallest normal fp32
_F32_EPS = float(np.finfo(np.float32).eps)


def _bce_log(x: torch.Tensor) -> torch.Tensor:
    """torch BCELoss's `max(log(x), -100)` with a NaN-free backward: the
    log never sees a value below the smallest normal fp32 (a subnormal
    would give 1/x = inf in the backward, and inf * 0 = NaN through the
    einsums after it). Selects, not products, keep the dead branch out of
    the gradient."""
    live = x >= _F32_TINY
    safe = torch.where(live, x, torch.ones_like(x))
    return torch.where(live, torch.log(safe), torch.full_like(x, -100.0))


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) fp32 weights of JAX's `compute_weight_mat` for
    a plain resize (translation 0) with the triangle kernel and
    antialiasing: every step in fp32 in JAX's order."""
    f32 = torch.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=f32)
    sample_f = ((torch.arange(out_size, dtype=f32) + 0.5)
                * torch.tensor(inv_scale, dtype=f32) - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs() / kernel_scale
    weights = torch.clamp_min(1.0 - x, 0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * _F32_EPS,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    with trace.sync("grounding.resize_weights"):
        return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(device)


def _resize_masks(masks: torch.Tensor, res: int) -> torch.Tensor:
    """(B, W, H0, W0) -> binarized (B, W, res, res) fp32: the antialiased
    bilinear resize, then `> 0`."""
    _, _, H0, W0 = masks.shape
    m = masks.float()
    if H0 != res:
        m = torch.einsum("bwyx,yi->bwix", m, _resize_weights(H0, res, m.device))
    if W0 != res:
        m = torch.einsum("bwix,xj->bwij", m, _resize_weights(W0, res, m.device))
    return (m > 0.0).float()


def grounding_losses_for_layer(
    attn_maps: List[torch.Tensor],  # L x (B, heads, HW, 77) (cond half)
    masks: torch.Tensor,            # (B, W, H0, W0) binary {0, 1}
    token_idx: torch.Tensor,        # (B, W, T) int
    token_valid: torch.Tensor,      # (B, W, T) bool
    word_valid: torch.Tensor,       # (B, W) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (token_loss, pixel_loss), each (B,): per-sample sums."""
    B, heads, HW, C = attn_maps[0].shape
    res = int(round(HW ** 0.5))
    m = _resize_masks(masks, res).reshape(masks.shape[0], masks.shape[1], HW)
    n_words = word_valid.sum(-1).clamp_min(1)      # (B,)
    E = (token_idx[..., None] == torch.arange(C, device=token_idx.device)
         ).float()                                  # (B, W, T, C)

    token_loss = torch.zeros(B, device=m.device)
    n_tok = token_valid.sum(-1).clamp_min(1)        # (B, W)
    for a in attn_maps:
        af = a.float()
        colsum = af.sum(dim=2)                      # (B, heads, C)
        den = torch.einsum("bhc,bwtc->bhwt", colsum, E)
        masked = torch.einsum("bhsc,bws->bhwc", af, m)
        num = torch.einsum("bhwc,bwtc->bhwt", masked, E)
        act = num / den.clamp_min(1e-12)
        per_tok = (1.0 - act.mean(dim=1)) ** 2      # (B, W, T)
        per_tok = torch.where(token_valid, per_tok, torch.zeros_like(per_tok))
        obj = per_tok.sum(-1) / n_tok               # (B, W)
        obj = torch.where(word_valid, obj, torch.zeros_like(obj))
        token_loss = token_loss + obj.sum(-1) / n_words

    # pixel loss: the maps averaged over layer instances and heads
    avg = sum(a.float().mean(dim=1) for a in attn_maps) / len(attn_maps)  # (B, HW, C)
    WE = (E * token_valid[..., None].float()).sum(dim=2)                  # (B, W, C)
    word_map = torch.einsum("bsc,bwc->bws", avg, WE).clamp(0.0, 1.0)
    bce = -(m * _bce_log(word_map) + (1.0 - m) * _bce_log(1.0 - word_map))
    bce = bce.mean(dim=-1)                          # (B, W)
    bce = torch.where(word_valid, bce, torch.zeros_like(bce))
    pixel_loss = bce.sum(-1) / n_words
    return token_loss, pixel_loss


def dedup_draw_weights(draws: torch.Tensor) -> torch.Tensor:
    """(A,) weights: 1 for the first occurrence of each drawn segment, 0
    for repeats. The reference's with-replacement draws collapse into one
    entry per timestep of its capture dict, so the loss sums over the
    distinct segments only."""
    A = draws.shape[0]
    earlier = torch.ones(A, A, dtype=torch.bool, device=draws.device).tril(-1)
    dup = (draws[None, :] == draws[:, None]) & earlier
    return (~dup.any(dim=1)).float()


def comat_grounding_loss(
    captured: Dict[str, List[torch.Tensor]],  # key -> [(A, B2, heads, HW, 77)]
    draw_weights: torch.Tensor,               # (A,)
    masks: torch.Tensor,                      # (B, W, H0, W0)
    token_idx: torch.Tensor,
    token_valid: torch.Tensor,
    word_valid: torch.Tensor,
    cond_offset: int,
    capture_layers: Sequence[str],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The token and pixel losses summed over the A captured segments and
    the layers of `capture_layers`, weighted by `draw_weights` and divided
    by the batch size. `cond_offset`: the row where the cond half starts
    (0 for maps captured cond-half only)."""
    B = masks.shape[0]
    token_total = torch.zeros((), device=masks.device)
    pixel_total = torch.zeros((), device=masks.device)
    for key in capture_layers:
        if key not in captured:
            continue
        layer_list = captured[key]
        for a in range(draw_weights.shape[0]):
            maps = [m[a][cond_offset:] for m in layer_list]
            tl, pl = grounding_losses_for_layer(
                maps, masks, token_idx, token_valid, word_valid)
            token_total = token_total + draw_weights[a] * tl.sum()
            pixel_total = pixel_total + draw_weights[a] * pl.sum()
    return token_total / B, pixel_total / B
