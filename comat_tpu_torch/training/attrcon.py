"""Attribute-concentration wiring for the train step.

Port of comat_tpu/training/attrcon.py (`make_attrcon_extra_losses`,
`attrcon_batch_fields`). The step captures the cross-attention maps at A
of its K replay segments, with-replacement draws injected as
`StepDraws.attrcon_draws` (JAX derives them with
`sample_attrcon_draws`, fold_in(rng, 0xA77C); `sample_draws` draws them
from the torch generator). Repeated draws weigh 0 in the loss
(`dedup_draw_weights`). The hook scores the captured maps against the
batch's per-noun masks (`batch["seg_masks"]`, (B, max_words, H, W)),
made when the batch is built for an image-independent segmenter.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from comat_tpu_torch import trace
from comat_tpu_torch.losses.grounding import comat_grounding_loss, dedup_draw_weights
from comat_tpu_torch.segmentation.interface import SegmenterHolder
from comat_tpu_torch.text.linguistics import extract_attribute_groups, pad_groups


def _tensor(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    if x.device.type != "cpu":      # made on the card (the split step's masks)
        return x.to(device)
    with trace.sync("attrcon.batch_fields"):
        return x.to(device)


def make_attrcon_extra_losses(pipeline, holder: SegmenterHolder, cfg):
    """extra(batch, image, result, draws) -> (loss to add, {token_loss,
    pixel_loss}): `mask_token_loss_weight` * token_loss +
    `mask_pixel_loss_weight` * pixel_loss over `result.captured` (maps
    captured cond-half only) and the layers `pipeline.cfg.capture_layers`."""

    def extra(batch, image, result, draws):
        device = pipeline.device
        with trace.sync("attrcon.draws"):
            draws_t = torch.tensor(list(draws.attrcon_draws), device=device)
        weights = dedup_draw_weights(draws_t)
        token_loss, pixel_loss = comat_grounding_loss(
            result.captured, weights,
            _tensor(batch["seg_masks"], device).float(),
            _tensor(batch["token_idx"], device).long(),
            _tensor(batch["token_valid"], device).bool(),
            _tensor(batch["word_valid"], device).bool(),
            cond_offset=0,
            capture_layers=pipeline.cfg.capture_layers,
        )
        add = (cfg.mask_token_loss_weight * token_loss
               + cfg.mask_pixel_loss_weight * pixel_loss)
        return add, {"token_loss": token_loss.detach(),
                     "pixel_loss": pixel_loss.detach()}

    return extra


def attrcon_batch_fields(
    prompts: List[str], tokenizer, holder: SegmenterHolder,
    max_length: int = 77,
    resolution: Optional[int] = None,
):
    """On the host: extract each prompt's attribute groups, align them to
    CLIP tokens and pad them (token_idx, token_valid, word_valid), arm
    `holder` with the batch's nouns and, for an image-independent
    segmenter with `resolution` given, add `seg_masks` (uint8,
    (B, max_words, resolution, resolution)) made now."""
    groups = [
        extract_attribute_groups(p, tokenizer, max_length) for p in prompts
    ]
    padded = pad_groups(groups, max_words=holder.max_words)
    holder.set_batch(padded.pop("nouns"))
    if resolution is not None and not holder.image_dependent:
        B = len(prompts)
        padded["seg_masks"] = holder.host_masks(
            np.zeros((B, resolution, resolution, 3), np.float32)
        ).astype(np.uint8)
    return padded
