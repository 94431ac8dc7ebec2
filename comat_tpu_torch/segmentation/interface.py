"""Segmentation masks for the grounding losses: one mask per noun.

Port of comat_tpu/segmentation/interface.py (`SegmenterHolder`,
`CenterPriorSegmenter`, `PrecomputedMaskSegmenter`), in numpy on the
host. The masks are frozen inputs of the step, outside the
differentiated graph (the reference computes them under no_grad,
attr_concen_utils/gsam_interface.py:54): image-independent segmenters
(the center prior, a precomputed store) make them when the batch is
built (`training.attrcon.attrcon_batch_fields`). The image-dependent
Grounded-SAM segmenter is not ported (ROADMAP Queue 1), nor is the JAX
`device_masks` callback bridge, which has no counterpart here.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


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
