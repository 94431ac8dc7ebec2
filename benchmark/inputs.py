"""Inputs the benchmark makes for a trainer cell, from the corpus and the
seed: a byte-level CLIP vocabulary learned from the corpus (what a real
tokenizer snapshot gives the trainer's native tokenizer) and the GAN's
latent store (.npy latents and their jsonl index, read by the trainer's
native store).

`write_byte_vocab` is a copy of chip_smoke.py's builder, with the
vocabulary's size taken from the text tower (BOS and EOS its last two
ids); the latent store holds latents drawn from the seed instead of
encoded images, so that neither side's weights make the data.
"""

from __future__ import annotations

import collections
import json
import os
import re
from typing import Dict, List

import numpy as np

CLIP_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
    r"[^\W\d_]+|[0-9]|[^\s\w']+|'(?!s|t|re|ve|m|ll|d)",
    re.IGNORECASE | re.UNICODE,
)


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP's reversible byte -> unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def read_lines(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def write_byte_vocab(path: str, lines: List[str], n_merges: int, vocab_size: int):
    """vocab.json (the 256 byte symbols, their </w> forms, `n_merges`
    merges learned greedily from the words of `lines`, the most frequent
    pair first; BOS and EOS at vocab_size - 2 and - 1) and merges.txt in
    `path`. Returns the folder."""
    enc = bytes_to_unicode()
    words = collections.Counter()
    for line in lines:
        for tok in CLIP_PAT.findall(line.lower()):
            sym = [enc[b] for b in tok.encode("utf-8")]
            words[tuple(sym[:-1] + [sym[-1] + "</w>"])] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, n in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += n
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append((a, b))
        merged = collections.Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    symbols = [enc[b] for b in range(256)]
    vocab = {}
    for tok in symbols + [t + "</w>" for t in symbols] + [a + b for a, b in merges]:
        vocab.setdefault(tok, len(vocab))
    if len(vocab) > vocab_size - 2:
        raise ValueError(f"{len(vocab)} pieces do not fit a vocabulary of {vocab_size}")
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = vocab_size - 2, vocab_size - 1
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return path


def write_latent_store(path: str, prompts: List[str], seed: int, size: int, n_files: int):
    """`n_files` latents (size, size, 4) float32 ~ N(0, 1) drawn from the
    seed, as .npy files, and index.jsonl giving every prompt one of them,
    round robin. Returns the index's path."""
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    for i in range(n_files):
        np.save(os.path.join(path, f"latent_{i}.npy"),
                rng.standard_normal((size, size, 4), dtype=np.float32))
    index = os.path.join(path, "index.jsonl")
    with open(index, "w") as f:
        for j, p in enumerate(prompts):
            f.write(json.dumps({"prompt": p, "file_path": f"latent_{j % n_files}.npy"}) + "\n")
    return index
