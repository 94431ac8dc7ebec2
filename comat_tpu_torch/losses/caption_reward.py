"""Concept-matching reward: the frozen BLIP captioner's cross-entropy.

Port of comat_tpu/losses/caption_reward.py (`blip_preprocess`,
`crop_jitter`, `build_caption_batch`, `blip_caption_reward`);
`blip_caption_rewards` is the per-image reward JAX's evaluator takes by
`vmap` of the scalar one. Images are
resized to 384x384 bicubic with antialiasing and CLIP-normalised, the
caption is "a photography of " + prompt.lower(), the labels mask padding
and the prompt prefix with -100, and the reward is minus the caption loss.
Images keep the JAX layout (B, H, W, 3); every step is differentiable with
respect to the image.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from comat_tpu_torch import trace

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
CAPTION_PREFIX = "a photography of"
IGNORE_INDEX = -100


@functools.lru_cache(maxsize=None)
def _resize_weights(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """(out_size, in_size) fp32 on `device`: row o holds the weights with which
    `F.interpolate(mode="bicubic", antialias=True)` sums the inputs into
    output o along one axis (its resize of the one-hot inputs; the other
    axis, unresized, passes each one-hot through unchanged)."""
    eye = torch.eye(in_size, dtype=torch.float64)[None, None]
    w = F.interpolate(eye, size=(out_size, in_size), mode="bicubic",
                      antialias=True, align_corners=False)
    return w[0, 0].float().to(device)


def blip_preprocess(image01: torch.Tensor, size: int = 384) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> (B, size, size, 3), bicubic with
    antialiasing (torchvision Resize(antialias=True), as
    `jax.image.resize(method="bicubic", antialias=True)`), then
    CLIP-normalised, in fp32.

    The resize is two products with `F.interpolate`'s weights, one per
    axis: its gradient is a product too, so a step repeats bit for bit on
    a CUDA card, where `F.interpolate`'s backward sums with float atomics."""
    _, H, W, _ = image01.shape
    wh = _resize_weights(H, size, image01.device)
    ww = _resize_weights(W, size, image01.device)
    x = torch.einsum("oh,bhwc->bowc", wh, image01.float())
    x = torch.einsum("pw,bowc->bopc", ww, x)
    with trace.sync("blip.image_stats"):
        mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32, device=x.device)
    with trace.sync("blip.image_stats"):
        std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def crop_jitter(image: torch.Tensor, offset_x: int, offset_y: int,
                size: int) -> torch.Tensor:
    """image[:, ox:ox+size, oy:oy+size, :] (the reference crops NCHW dims
    2 and 3, which are NHWC dims 1 and 2)."""
    ox, oy = int(offset_x), int(offset_y)
    return image[:, ox:ox + size, oy:oy + size, :]


def build_caption_batch(
    tokenizer, prompts, prompt_length: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Tokenize "a photography of " + prompt.lower() and build the labels,
    with the padding and the prefix masked."""
    texts = [f"{CAPTION_PREFIX} {p.lower()}" for p in prompts]
    batch = tokenizer(texts, padding="longest")
    ids, mask = batch["input_ids"], batch["attention_mask"]
    if prompt_length is None:
        prefix_ids = tokenizer([CAPTION_PREFIX], padding="longest")["input_ids"]
        prompt_length = int(prefix_ids.shape[1]) - 1
    labels = np.where(mask == 1, ids, IGNORE_INDEX)
    labels[:, :prompt_length] = IGNORE_INDEX
    return {
        "input_ids": ids.astype(np.int32),
        "attention_mask": mask.astype(np.int32),
        "labels": labels.astype(np.int32),
    }


def blip_caption_reward(
    blip, image01: torch.Tensor, input_ids, attention_mask, labels,
    token_count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """reward = -caption_loss, a scalar, differentiable with respect to
    `image01`; the captioner's weights are frozen. `token_count`: the
    count of scored tokens to divide by, the whole batch's where these
    rows are one rank's share of it (else these rows' own)."""
    device = image01.device

    def as_ids(a):
        with trace.sync("blip.caption_ids"):
            return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                                   device=device).long()

    pixel_values = blip_preprocess(image01, blip.cfg.image_size)
    loss = blip.caption_loss(pixel_values, as_ids(input_ids),
                             as_ids(attention_mask), as_ids(labels), token_count)
    return -loss


def blip_caption_rewards(
    blip, image01: torch.Tensor, input_ids, attention_mask, labels,
) -> torch.Tensor:
    """(B,) rewards, one per image, each what `blip_caption_reward` gives
    for that image and its caption row alone (the mean over the row's
    scored tokens), from one batched forward."""
    device = image01.device

    def as_ids(a):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                               device=device).long()

    pixel_values = blip_preprocess(image01, blip.cfg.image_size)
    per_tok, valid = blip.caption_token_losses(pixel_values, as_ids(input_ids),
                                               as_ids(attention_mask), as_ids(labels))
    return -(per_tok.sum(-1) / valid.sum(-1).clamp_min(1))
