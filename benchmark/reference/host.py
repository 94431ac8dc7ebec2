"""The host half of a trainer step, worked out again in plain Python and
NumPy from what the benchmark itself wrote and drew:

- `ClipBPE`: CLIP's byte-pair encoding over the vocabulary the benchmark
  wrote (`inputs.write_byte_vocab`): the prompts' ids, BOS and EOS framed,
  cut to the text tower's length and padded with EOS, the EOS position;
- `captions`: the caption reward's ids, mask and labels, "a photography
  of " and the lower-cased prompt under the BLIP stand-in tokenizer (an
  md5 hash of each word, CLS and SEP framed), the prefix and the padding
  masked in the labels;
- `latent_files`: the GAN latents the benchmark's store gives each prompt;
- `decode_masks`: Grounded-SAM's host decode (FastSAM's proposals by the
  DFL box integral, greedy NMS and prototype masks; GroundingDINO's boxes
  given to the nouns whose tokens pass the thresholds; each noun the
  union of its boxes' best proposals by IoU), from the detectors' raw
  outputs on the device.

`host_gap` counts every entry of the program's host batch and masks that
differs from these. The attribute parse (which words are grouped with
which nouns) is the program's; only that its token indices point at the
prompt's own tokens is checked.
"""

from __future__ import annotations

import hashlib
import html
import json
import os
import re
from typing import Dict, List, Sequence

import numpy as np

from benchmark import inputs

CAPTION_PREFIX = "a photography of"
CAPTION_PAD = 64             # the caption batch's padded length
IGNORE = -100
# GroundingDINO's and FastSAM's thresholds as Grounded-SAM calls them
BOX_THRESHOLD, TEXT_THRESHOLD = 0.3, 0.25
CONF, IOU, MAX_DET = 0.4, 0.9, 100


def clean(text: str) -> str:
    return re.sub(r"\s+", " ", html.unescape(html.unescape(text))).strip().lower()


class ClipBPE:
    """CLIP's tokenizer over `folder`'s vocab.json and merges.txt."""

    def __init__(self, folder: str):
        with open(os.path.join(folder, "vocab.json"), encoding="utf-8") as f:
            self.vocab: Dict[str, int] = json.load(f)
        with open(os.path.join(folder, "merges.txt"), encoding="utf-8") as f:
            pairs = [tuple(ln.split()) for ln in f.read().splitlines()[1:] if ln.strip()]
        self.pairs = pairs
        self.rank = {p: i for i, p in enumerate(pairs)}
        self.byte = inputs.bytes_to_unicode()
        self.bos, self.eos = self.vocab["<|startoftext|>"], self.vocab["<|endoftext|>"]

    def pieces(self, word: str) -> List[str]:
        sym = [self.byte[b] for b in word.encode("utf-8")]
        sym[-1] += "</w>"
        while len(sym) > 1:
            ranked = [(self.rank.get(p, len(self.rank)), i)
                      for i, p in enumerate(zip(sym, sym[1:]))]
            best, _ = min(ranked)
            if best == len(self.rank):
                break
            a, b = self.pairs[best]
            out, i = [], 0
            while i < len(sym):
                if i + 1 < len(sym) and sym[i] == a and sym[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            sym = out
        return sym

    def row(self, text: str, length: int):
        """(ids padded to `length`, the EOS position)."""
        ids = [self.bos] + [self.vocab[p] for w in inputs.CLIP_PAT.findall(clean(text))
                            for p in self.pieces(w)] + [self.eos]
        if len(ids) > length:
            ids = ids[:length - 1] + [self.eos]
        return ids + [self.eos] * (length - len(ids)), len(ids) - 1


def _hash_id(word: str, vocab: int) -> int:
    return 3 + int(hashlib.md5(word.encode()).hexdigest(), 16) % (vocab - 3)


def captions(prompts: Sequence[str], vocab: int) -> Dict[str, np.ndarray]:
    """The caption reward's ids, mask and labels (CLS 1, SEP 2, rows padded
    with 2 to the longest and then with 0 to CAPTION_PAD)."""
    def enc(text):
        return [1] + [_hash_id(w, vocab) for w in inputs.CLIP_PAT.findall(text.lower())] + [2]

    rows = [enc(f"{CAPTION_PREFIX} {p.lower()}") for p in prompts]
    longest = max(len(r) for r in rows)
    ids = np.zeros((len(rows), max(longest, CAPTION_PAD)), np.int64)
    mask = np.zeros_like(ids)
    for i, r in enumerate(rows):
        ids[i, :longest] = 2
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    labels = np.where(mask == 1, ids, IGNORE)
    labels[:, :len(enc(CAPTION_PREFIX)) - 1] = IGNORE
    return {"caption_ids": ids[:, :CAPTION_PAD], "caption_mask": mask[:, :CAPTION_PAD],
            "caption_labels": labels[:, :CAPTION_PAD]}


def latent_files(store_index: str) -> Dict[str, List[np.ndarray]]:
    """Each prompt's latents in the store the benchmark wrote."""
    root = os.path.dirname(store_index)
    out: Dict[str, List[np.ndarray]] = {}
    cache: Dict[str, np.ndarray] = {}
    with open(store_index) as f:
        for line in f:
            e = json.loads(line)
            path = e["file_path"]
            if path not in cache:
                cache[path] = np.load(os.path.join(root, path))
            out.setdefault(e["prompt"], []).append(cache[path])
    return out


# ---------------------------------------------------------------- masks

def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _proposals(outs, protos, b: int):
    """FastSAM's proposals of image b: boxes (N, 4) xyxy px and masks (N,
    ph, pw) bool."""
    all_boxes, all_scores, all_coef = [], [], []
    for lvl, o in enumerate(outs):
        stride = 8 * 2 ** lvl
        box, cls, coef = o["box"][b], o["cls"][b], o["mc"][b]
        reg = box.shape[-1] // 4
        prob = _sigmoid(cls)
        ys, xs = np.where(prob.max(-1) > CONF)
        if len(ys) == 0:
            continue
        d = box[ys, xs].reshape(-1, 4, reg)
        d = np.exp(d - d.max(-1, keepdims=True))
        d /= d.sum(-1, keepdims=True)
        dist = (d * np.arange(reg)).sum(-1)
        cx, cy = xs + 0.5, ys + 0.5
        all_boxes.append(np.stack([(cx - dist[:, 0]) * stride, (cy - dist[:, 1]) * stride,
                                   (cx + dist[:, 2]) * stride, (cy + dist[:, 3]) * stride], -1))
        all_scores.append(prob[ys, xs].max(-1))
        all_coef.append(coef[ys, xs])
    ph, pw, nm = protos.shape[1:]
    if not all_boxes:
        return np.zeros((0, 4)), np.zeros((0, ph, pw), bool)
    boxes, scores, coef = (np.concatenate(a) for a in (all_boxes, all_scores, all_coef))
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    keep, order = [], np.argsort(-scores)
    while len(order) and len(keep) < MAX_DET:
        i, rest = order[0], order[1:]
        keep.append(i)
        iw = np.maximum(np.minimum(boxes[i, 2], boxes[rest, 2])
                        - np.maximum(boxes[i, 0], boxes[rest, 0]), 0)
        ih = np.maximum(np.minimum(boxes[i, 3], boxes[rest, 3])
                        - np.maximum(boxes[i, 1], boxes[rest, 1]), 0)
        inter = iw * ih
        order = rest[inter / np.maximum(area[i] + area[rest] - inter, 1e-9) <= IOU]
    boxes, coef = boxes[keep], coef[keep]
    soft = _sigmoid(protos[b].reshape(-1, nm) @ coef.T).T.reshape(-1, ph, pw)
    masks = np.zeros(soft.shape, bool)
    for i, (x1, y1, x2, y2) in enumerate(boxes / 4.0):
        xa, xb = max(int(x1), 0), min(int(np.ceil(x2)), pw)
        ya, yb = max(int(y1), 0), min(int(np.ceil(y2)), ph)
        masks[i, ya:yb, xa:xb] = soft[i, ya:yb, xa:xb] > 0.5
    return boxes, masks


def _best_proposal(masks, table, box_xyxy, H: int, W: int):
    """The proposal with the highest IoU against the box (first of equal
    IoUs), or None: a proposal pixel is inside the box when its centre is,
    counted from `table`, the masks' summed-area table."""
    if len(masks) == 0:
        return None
    ph, pw = masks.shape[1:]
    f32 = np.float32
    x1, y1, x2, y2 = np.asarray(box_xyxy, f32)
    q = np.array([x1 * f32(pw) / f32(W), y1 * f32(ph) / f32(H),
                  x2 * f32(pw) / f32(W), y2 * f32(ph) / f32(H)], f32)
    # pixel x is inside when q0 <= x + 0.5 <= q2
    xa = max(int(np.ceil(np.float64(q[0]) - 0.5)), 0)
    xb = min(int(np.floor(np.float64(q[2]) - 0.5)) + 1, pw)
    ya = max(int(np.ceil(np.float64(q[1]) - 0.5)), 0)
    yb = min(int(np.floor(np.float64(q[3]) - 0.5)) + 1, ph)
    if xa < xb and ya < yb:
        inter = (table[:, yb, xb] - table[:, ya, xb] - table[:, yb, xa]
                 + table[:, ya, xa]).astype(f32)
    else:
        inter = np.zeros(len(masks), f32)
    area = table[:, ph, pw].astype(f32)
    q_area = f32(max((q[2] - q[0]) * (q[3] - q[1]), f32(1e-9)))
    return int(np.argmax(inter / np.maximum(area + q_area - inter, f32(1e-9))))


def _noun_spans(nouns: Sequence[str]):
    """Each noun's token span in " . ".join(nouns) under the detector's
    stand-in tokenizer (a token a word, CLIP's word split)."""
    spans, pos = [], 0
    for noun in nouns:
        n = len(inputs.CLIP_PAT.findall(noun.lower()))
        spans.append((pos, pos + n))
        pos += n + 1
    return spans


def decode_masks(nouns: Sequence[Sequence[str]], boxes, logits, outs, protos, H: int,
                 W: int, max_words: int) -> np.ndarray:
    """(B, max_words, H, W) uint8: each image's nouns' masks from the
    detectors' outputs (GroundingDINO: boxes (B, Nq, 4) cxcywh in [0, 1],
    token logits (B, Nq, T); FastSAM: per level {box, cls, mc} and the
    prototypes (B, ph, pw, nm))."""
    B = len(nouns)
    out = np.zeros((B, max_words, H, W), np.uint8)
    for b in range(B):
        if not nouns[b]:
            continue
        _, prop_masks = _proposals(outs, protos, b)
        table = np.zeros((len(prop_masks),) + tuple(np.add(prop_masks.shape[1:], 1)), np.int64)
        table[:, 1:, 1:] = prop_masks.cumsum(1).cumsum(2)
        probs = _sigmoid(logits[b].astype(np.float64))
        passing = np.flatnonzero(probs.max(-1) >= BOX_THRESHOLD)
        best = {}
        for ni, (a, e) in enumerate(_noun_spans(nouns[b])[:max_words]):
            chosen = set()
            for i in passing:
                if e <= a or probs[i, a:e].max() <= TEXT_THRESHOLD:
                    continue
                if i not in best:
                    cx, cy, w, h = boxes[b][i]
                    best[i] = _best_proposal(prop_masks, table,
                                             [(cx - w / 2) * W, (cy - h / 2) * H,
                                              (cx + w / 2) * W, (cy + h / 2) * H], H, W)
                if best[i] is not None:
                    chosen.add(best[i])
            if chosen:
                union = prop_masks[sorted(chosen)].any(0)
                ph, pw = union.shape
                rows = np.floor((np.arange(H, dtype=np.float32) + 0.5) * ph / H).astype(int)
                cols = np.floor((np.arange(W, dtype=np.float32) + 0.5) * pw / W).astype(int)
                out[b, ni] = union[rows[:, None], cols[None, :]]
    return out


# ---------------------------------------------------------------- the count

def host_gap(kept: Sequence[dict], tok_dir: str, store_index: str, text_len: int,
             caption_vocab: int) -> Dict[str, int]:
    """Entries of the program's host batches and masks that differ from the
    plain ones, by field, summed over the checked steps. `kept`: per step
    {"prompts", "batch" (the program's host fields), and, where the
    segmenter is Grounded-SAM, "seg": (nouns, boxes, logits, outs, protos,
    H, W) and "masks" (the program's decoded masks)}."""
    bpe = ClipBPE(tok_dir)
    store = latent_files(store_index)
    gaps: Dict[str, int] = {}

    def add(name, want, got):
        want = np.asarray(want)
        got = None if got is None else np.asarray(got)
        n = (want.size if got is None or got.shape != want.shape
             else int((want.astype(np.float64) != got.astype(np.float64)).sum()))
        gaps[name] = gaps.get(name, 0) + n

    for k in kept:
        prompts, batch = k["prompts"], k["batch"]
        rows = [bpe.row(p, text_len) for p in prompts]
        add("input_ids", [r for r, _ in rows], batch["input_ids"])
        add("eos_positions", [e for _, e in rows], batch["eos_positions"])
        add("null_ids", [bpe.row("", text_len)[0]] * len(prompts), batch["null_ids"])
        for name, want in captions(prompts, caption_vocab).items():
            add(name, want, batch[name])
        gt = batch["gt_latents"]
        found = [gt is not None and any(np.array_equal(gt[i], f) for f in store.get(p, []))
                 for i, p in enumerate(prompts)]
        gaps["gt_latents"] = gaps.get("gt_latents", 0) + found.count(False)
        eos = np.asarray([e for _, e in rows])[:, None, None]
        tidx = np.asarray(batch["token_idx"])
        tval = np.asarray(batch["token_valid"]).astype(bool)
        live = tval & np.asarray(batch["word_valid"])[:, :, None].astype(bool)
        gaps["token_idx"] = gaps.get("token_idx", 0) + int(
            (live & ((tidx < 1) | (tidx >= eos))).sum())
        if k.get("seg") is not None:
            nouns, boxes, logits, outs, protos, H, W = k["seg"]
            add("masks", decode_masks(nouns, boxes, logits, outs, protos, H, W,
                                      k["masks"].shape[1]), k["masks"])
    return gaps
