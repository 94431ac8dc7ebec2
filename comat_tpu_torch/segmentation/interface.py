"""Segmentation masks for the grounding losses: one mask per noun.

Port of comat_tpu/segmentation/interface.py (`SegmenterHolder`,
`CenterPriorSegmenter`, `PrecomputedMaskSegmenter`). The masks are frozen
inputs of the step, outside the differentiated graph (the reference
computes them under no_grad, attr_concen_utils/gsam_interface.py:54):
- image-independent segmenters (the center prior, a precomputed store)
  make them on the host when the batch is built
  (`training.attrcon.attrcon_batch_fields`, `host_masks`);
- the image-dependent Grounded-SAM segmenter
  (segmentation/grounded_sam.py) segments the presample's decoded image:
  the trainer runs the no-grad presample (pass 1 and the VAE decode,
  `training.train_step.make_presample`), `device_masks` hands the image,
  clipped to [0, 1], to the segmenter on the card and returns the masks
  there, and the differentiable step replays pass 1 from the presample's
  tables. JAX's `device_masks` host-callback bridge has no counterpart.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


class SegmenterHolder:
    """The segmenter and the nouns of the current batch (set before each
    step, read when its masks are made)."""

    def __init__(self, segmenter, max_words: int = 8):
        self.segmenter = segmenter
        self.max_words = max_words
        self.nouns: List[List[str]] = []

    @property
    def image_dependent(self) -> bool:
        """True when masks depend on the generated pixels; the center
        prior and precomputed stores look at the noun strings only."""
        return bool(getattr(self.segmenter, "image_dependent", False))

    def set_batch(self, nouns_per_sample: List[List[str]]):
        self.nouns = nouns_per_sample

    def host_masks(self, images01: np.ndarray) -> np.ndarray:
        """images (B, H, W, 3) in [0, 1] -> masks (B, max_words, H, W)
        float32, one per noun of each sample, zeros past its nouns."""
        B, H, W, _ = images01.shape
        out = np.zeros((B, self.max_words, H, W), np.float32)
        nouns = self.nouns if self.nouns else [[] for _ in range(B)]
        batch_fn = getattr(self.segmenter, "batch", None)
        if batch_fn is not None and B > 1:
            all_masks = batch_fn(
                images01,
                [nouns[b] if b < len(nouns) else [] for b in range(B)],
            )
            for b in range(B):
                for w, m in enumerate(all_masks[b][: self.max_words]):
                    out[b, w] = m
            return out
        for b in range(min(B, len(nouns))):
            masks = self.segmenter(images01[b], nouns[b])
            for w, m in enumerate(masks[: self.max_words]):
                out[b, w] = m
        return out

    def device_masks(self, image: torch.Tensor,
                     mark: Optional[Callable[[str], None]] = None) -> torch.Tensor:
        """The masks of a generated image, on its device: image (B, H, W, 3)
        (unclamped; clipped to [0, 1] here) -> (B, max_words, H, W) uint8,
        as the JAX trainer feeds them to its step. A segmenter with `batch`
        gets the whole batch (B > 1) on the device; otherwise each image is
        segmented alone. `mark("segment_device")` is called once the
        segmenter's device work is queued; `mark("segmented")` once the
        masks are back on the device."""
        B, H, W, _ = image.shape
        img = image.detach().float().clamp(0.0, 1.0)
        out = np.zeros((B, self.max_words, H, W), np.uint8)
        nouns = self.nouns if self.nouns else [[] for _ in range(B)]
        batch_fn = getattr(self.segmenter, "batch", None)
        if batch_fn is not None and B > 1:
            all_masks = batch_fn(img, [nouns[b] if b < len(nouns) else []
                                       for b in range(B)], mark=mark)
        else:
            if mark is not None:
                mark("segment_device")
            all_masks = [self.segmenter(img[b], nouns[b]) if b < len(nouns) else []
                         for b in range(B)]
        for b in range(B):
            for w, m in enumerate(all_masks[b][: self.max_words]):
                out[b, w] = m
        masks = torch.from_numpy(out).to(image.device)
        if mark is not None:
            mark("segmented")
        return masks


class CenterPriorSegmenter:
    """Weight-free fallback: one center box per noun, the nouns tiled
    across the middle band."""

    def __call__(self, image01: np.ndarray, nouns: Sequence[str]) -> List[np.ndarray]:
        H, W, _ = image01.shape
        n = len(nouns)
        masks = []
        for i in range(n):
            m = np.zeros((H, W), np.float32)
            x0 = int(W * (0.1 + 0.8 * i / max(n, 1)))
            x1 = int(W * (0.1 + 0.8 * (i + 1) / max(n, 1)))
            y0, y1 = int(H * 0.2), int(H * 0.8)
            m[y0:y1, x0:x1] = 1.0
            masks.append(m)
        return masks


class PrecomputedMaskSegmenter:
    """Masks from an .npz store keyed by noun string (offline
    segmentation runs); a noun the store lacks gets an empty mask."""

    def __init__(self, npz_path: str):
        self.store = np.load(npz_path)

    def __call__(self, image01: np.ndarray, nouns: Sequence[str]) -> List[np.ndarray]:
        H, W, _ = image01.shape
        out = []
        for n in nouns:
            if n in self.store:
                m = self.store[n].astype(np.float32)
                if m.shape != (H, W):
                    from PIL import Image

                    m = np.asarray(
                        Image.fromarray((m * 255).astype(np.uint8)).resize(
                            (W, H)
                        ),
                        np.float32,
                    ) / 255.0
                out.append((m > 0.5).astype(np.float32))
            else:
                out.append(np.zeros((H, W), np.float32))
        return out
