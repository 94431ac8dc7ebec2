"""Datasets and host-side batch assembly.

The port's own copy of comat_tpu/training/data.py: the same prompt order
for the same seed (`random.Random`), the same latent store and batches.
Reference: training_utils/dataset.py (prompt txt/json datasets,
per-process shuffle with seed + process_index) and gan_dataset.py
(jsonl-indexed pre-generated latents from a ceph object store —
replaced here by a filesystem/npy latent store with the same jsonl
index contract: lines of {"prompt": ..., "file_path": ...}).

Batches are fixed-shape (captions padded to a static bucket), as in JAX,
and carry SDXL's second tokenizer's ids where it is given.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from comat_tpu_torch.losses.caption_reward import build_caption_batch

CAPTION_BUCKET = 64  # BERT tokens: prefix(5) + prompt + [SEP], padded


def load_prompts(path: str, max_samples: Optional[int] = None) -> List[str]:
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        prompts = [d["text"] if isinstance(d, dict) else d for d in data]
    else:
        with open(path) as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
    if max_samples:
        prompts = prompts[:max_samples]
    return prompts


class PromptDataset:
    """Shuffled prompt stream, per-process sharded.

    The reference shuffles with `seed + process_index`
    (training_utils/dataset.py:39) and lets the DDP dataloader shard;
    here every process shuffles with the same seed, and step i's global
    batch is the shuffled order's i-th block of batch_size x
    process_count prompts, of which process k takes the k-th
    batch_size rows. JAX's copy strides the order by process_count
    instead: the same exact partition, but the port's keeps each global
    batch, in order, what one process at the global batch size sees, so
    that N processes train as one at N times the batch, step for step.
    """

    def __init__(
        self,
        prompts: Sequence[str],
        batch_size: int,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.prompts = list(prompts)
        self.batch_size = batch_size
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count

    def __len__(self):
        return max(
            len(self.prompts) // (self.batch_size * self.process_count), 1
        )

    def epoch(self, epoch: int) -> Iterator[List[str]]:
        order = list(range(len(self.prompts)))
        # Deviation from the reference (documented): the reference
        # shuffles with seed + process_index and lets the DDP loader
        # stride (dataset.py:39) — different per-process orders make the
        # strided shards OVERLAP (sampling with replacement across
        # ranks). Here all processes share one shuffle, then stride:
        # an exact partition, same randomness.
        rng = random.Random(self.seed + epoch * 1000003)
        rng.shuffle(order)
        step = self.batch_size * self.process_count
        if len(order) < step:  # tiny corpora: tile to fill
            reps = -(-step // max(len(order), 1))
            order = (order * reps)[:step]
        lo = self.process_index * self.batch_size
        for i in range(0, len(order) - step + 1, step):
            yield [self.prompts[j] for j in order[i + lo : i + lo + self.batch_size]]


class GanLatentStore:
    """jsonl-indexed latent store (reference: Gan_Dataset,
    training_utils/gan_dataset.py:40-66). Multiple entries per prompt
    are allowed; sampling picks one at random (:59), from a
    `random.Random(seed)` that is seed 0 in every process, as in JAX: each
    process draws for its own prompts."""

    def __init__(self, index_path: str, root: Optional[str] = None, seed: int = 0):
        self.root = root or os.path.dirname(os.path.abspath(index_path))
        self.by_prompt: Dict[str, List[str]] = {}
        with open(index_path) as f:
            for line in f:
                if not line.strip():
                    continue
                rec = json.loads(line)
                self.by_prompt.setdefault(rec["prompt"], []).append(
                    rec["file_path"]
                )
        self.rng = random.Random(seed)

    def prompts(self) -> List[str]:
        return list(self.by_prompt.keys())

    def _load(self, rel: str) -> np.ndarray:
        path = rel if os.path.isabs(rel) else os.path.join(self.root, rel)
        if path.endswith(".npy"):
            return np.load(path)
        if path.endswith(".pt"):
            import torch

            return torch.load(path, map_location="cpu").float().numpy()
        raise ValueError(f"unknown latent format: {path}")

    def sample(self, prompt: str) -> np.ndarray:
        files = self.by_prompt[prompt]
        lat = self._load(self.rng.choice(files))
        # stored layout: reference saves torch NCHW (gan_gt_generate.py);
        # our tooling saves NHWC npy. Normalize to NHWC.
        if lat.ndim == 3 and lat.shape[0] == 4:
            lat = np.transpose(lat, (1, 2, 0))
        return lat

    def batch(self, prompts: Sequence[str]) -> np.ndarray:
        return np.stack([self.sample(p) for p in prompts])


def assemble_batch(
    prompts: Sequence[str],
    clip_tokenizer,
    caption_tokenizer,
    max_length: int = 77,
    caption_bucket: int = CAPTION_BUCKET,
    latent_store: Optional[GanLatentStore] = None,
    clip_tokenizer2=None,
) -> Dict[str, np.ndarray]:
    """Host-side tokenization -> fixed-shape device batch. With SDXL's
    second tokenizer (`clip_tokenizer2`: the same BPE, padding with "!",
    id 0) also `input_ids2` and `null_ids2`."""
    B = len(prompts)
    enc = clip_tokenizer(list(prompts), max_length=max_length)
    null = clip_tokenizer([""] * B, max_length=max_length)
    cap = build_caption_batch(caption_tokenizer, prompts)

    def pad_to(a: np.ndarray, L: int, value) -> np.ndarray:
        if a.shape[1] >= L:
            return a[:, :L]
        return np.pad(a, ((0, 0), (0, L - a.shape[1])), constant_values=value)

    batch = {
        "input_ids": enc["input_ids"],
        "eos_positions": enc.get(
            "eos_positions", np.full((B,), max_length - 1, np.int32)
        ),
        "null_ids": null["input_ids"],
        "caption_ids": pad_to(cap["input_ids"], caption_bucket, 0),
        "caption_mask": pad_to(cap["attention_mask"], caption_bucket, 0),
        "caption_labels": pad_to(cap["labels"], caption_bucket, -100),
    }
    if clip_tokenizer2 is not None:
        batch["input_ids2"] = clip_tokenizer2(list(prompts), max_length=max_length)[
            "input_ids"]
        batch["null_ids2"] = clip_tokenizer2([""] * B, max_length=max_length)[
            "input_ids"]
    if latent_store is not None:
        batch["gt_latents"] = latent_store.batch(prompts).astype(np.float32)
    return batch
