"""Tokenizers for the PyTorch port: CLIP BPE, BERT WordPiece and the hash
stand-in.

The port's own copy of comat_tpu/text/tokenizer.py (`CLIPBPETokenizer`,
`BertWordPieceTokenizer`, `HashTokenizer`, `load_clip_tokenizer`); the
port imports nothing of the JAX package. Vocabularies load from local HF-format files (vocab.json +
merges.txt); without them `HashTokenizer` gives stable ids with the same
BOS/EOS framing and EOS padding.
"""

from __future__ import annotations

import functools
import html
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CLIP_BOS = 49406
CLIP_EOS = 49407
CLIP_MAX_LEN = 77


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte->unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


# CLIP's regex uses unicode \p{L}/\p{N} classes (regex module); the
# stdlib-re equivalent below uses str.isalpha-compatible classes, which
# match it on the ASCII prompt corpora the reference trains on
# (collected_data/*.txt are ASCII).
_CLIP_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
    r"[^\W\d_]+|[0-9]|[^\s\w']+|'(?!s|t|re|ve|m|ll|d)",
    re.IGNORECASE | re.UNICODE,
)


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def clean_text(text: str) -> str:
    """What the CLIP tokenizers split: HTML entities resolved (twice, as
    CLIP does), whitespace runs made one space, lower case."""
    return _whitespace_clean(html.unescape(html.unescape(text))).lower()


class CLIPBPETokenizer:
    """CLIP byte-pair encoding tokenizer (OpenAI vocab, 49408 tokens).

    Load from HF-format files: `vocab_path` (vocab.json) and
    `merges_path` (merges.txt). `encode` appends '</w>' to word tokens
    and wraps with BOS/EOS like HF CLIPTokenizer.
    """

    def __init__(self, vocab_path: str, merges_path: str,
                 pad_token_id: Optional[int] = None):
        with open(vocab_path, "r", encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        merges: List[Tuple[str, str]] = []
        with open(merges_path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                line = line.strip()
                if i == 0 and line.startswith("#"):
                    continue
                if not line:
                    continue
                a, b = line.split()
                merges.append((a, b))
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache: Dict[str, str] = {}
        self.bos_token_id = self.encoder.get("<|startoftext|>", CLIP_BOS)
        self.eos_token_id = self.encoder.get("<|endoftext|>", CLIP_EOS)
        # CLIP-L pads with EOS; SDXL's tokenizer_2 pads with "!" (id 0)
        # — pass pad_token_id=0 for that variant (HF CLIPTokenizer
        # pad_token differs between SDXL's tokenizer and tokenizer_2).
        self.pad_token_id = (
            self.eos_token_id if pad_token_id is None else pad_token_id
        )

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> List[int]:
        text = clean_text(text)
        ids: List[int] = []
        for tok in _CLIP_PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(
                self.encoder[t] for t in self.bpe(tok).split(" ")
            )
        return ids

    def encode(self, text: str) -> List[int]:
        """BOS + tokens + EOS (untruncated), HF `tokenizer.encode` style."""
        return [self.bos_token_id] + self.tokenize(text) + [self.eos_token_id]

    def encode_to_tokens(self, text: str) -> List[str]:
        """Wordpiece strings of the untruncated encoding, BOS/EOS
        included, '</w>' kept on word-final pieces — what HF
        `convert_ids_to_tokens(tokenizer(p).input_ids)` yields
        (consumed by linguistics.get_indices; reference
        attribute_concen_utils.py:134-143)."""
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        def _piece_to_text(piece: str) -> str:
            suffix = ""
            if piece.endswith("</w>"):
                piece, suffix = piece[:-4], "</w>"
            raw = bytearray(
                byte_decoder[c] for c in piece if c in byte_decoder
            )
            return raw.decode("utf-8", errors="replace") + suffix

        text = clean_text(text)
        pieces: List[str] = ["<|startoftext|>"]
        for tok in _CLIP_PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            pieces.extend(
                _piece_to_text(t) for t in self.bpe(tok).split(" ")
            )
        pieces.append("<|endoftext|>")
        return pieces

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        raw = bytearray(byte_decoder[c] for c in text if c in byte_decoder)
        return (
            raw.decode("utf-8", errors="replace")
            .replace("</w>", " ")
            .strip()
        )

    def __call__(
        self, texts: Sequence[str], max_length: int = CLIP_MAX_LEN
    ) -> Dict[str, np.ndarray]:
        """Batch encode, padded with EOS to max_length (CLIP convention:
        model_max_length 77, pad with eos). Returns input_ids and the
        eos position per row (first EOS — what pooled output indexes)."""
        rows, eos_pos = [], []
        for t in texts:
            ids = self.encode(t)
            if len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.eos_token_id]
            eos_pos.append(len(ids) - 1)
            ids = ids + [self.pad_token_id] * (max_length - len(ids))
            rows.append(ids)
        return {
            "input_ids": np.asarray(rows, dtype=np.int32),
            "eos_positions": np.asarray(eos_pos, dtype=np.int32),
        }


class BertWordPieceTokenizer:
    """BERT-uncased WordPiece from a vocab.txt (GroundingDINO's and BLIP's
    text tokenizer)."""

    def __init__(self, vocab_path: str):
        self.vocab: Dict[str, int] = {}
        with open(vocab_path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.cls_token_id = self.vocab.get("[CLS]", 101)
        self.sep_token_id = self.vocab.get("[SEP]", 102)
        self.pad_token_id = self.vocab.get("[PAD]", 0)
        self.unk_token_id = self.vocab.get("[UNK]", 100)

    @staticmethod
    def _basic_tokenize(text: str) -> List[str]:
        text = text.lower()
        out: List[str] = []
        buf = ""
        for ch in text:
            if ch.isalnum():
                buf += ch
            else:
                if buf:
                    out.append(buf)
                    buf = ""
                if not ch.isspace():
                    out.append(ch)
        if buf:
            out.append(buf)
        return out

    def _wordpiece(self, word: str) -> List[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_token_id]
            ids.append(cur)
            start = end
        return ids

    def tokenize(self, text: str) -> List[int]:
        ids: List[int] = []
        for w in self._basic_tokenize(text):
            ids.extend(self._wordpiece(w))
        return ids

    def __call__(self, texts: Sequence[str], padding: str = "longest"
                 ) -> Dict[str, np.ndarray]:
        rows = [[self.cls_token_id] + self.tokenize(t) + [self.sep_token_id]
                for t in texts]
        max_len = max(len(r) for r in rows)
        ids = np.full((len(rows), max_len), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(rows), max_len), dtype=np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class HashTokenizer:
    """Deterministic stand-in for weight-free tests: word -> stable id.

    Mimics CLIP conventions (BOS/EOS wrap, EOS pad) with a small vocab.
    """

    def __init__(self, vocab_size: int = 1000,
                 pad_token_id: Optional[int] = None):
        self.vocab_size = vocab_size
        self.bos_token_id = 1
        self.eos_token_id = 2
        # pad_token_id=0 mimics SDXL's tokenizer_2 ("!"-padding) so
        # tiny tests can assert input_ids2 != input_ids under padding
        self.pad_token_id = 2 if pad_token_id is None else pad_token_id
        self.cls_token_id = 1
        self.sep_token_id = 2

    def _wid(self, w: str) -> int:
        import hashlib

        h = int(hashlib.md5(w.encode()).hexdigest(), 16)
        return 3 + (h % (self.vocab_size - 3))

    @staticmethod
    def _words(text: str) -> List[str]:
        # CLIP-style pre-tokenization (punctuation split off) so
        # wordpiece positions line up with CLIPBPETokenizer's.
        return _CLIP_PAT.findall(text.lower())

    def tokenize(self, text: str) -> List[int]:
        return [self._wid(w) for w in self._words(text)]

    def encode(self, text: str) -> List[int]:
        return [self.bos_token_id] + self.tokenize(text) + [self.eos_token_id]

    def encode_to_tokens(self, text: str) -> List[str]:
        """Whole words as single 'wordpieces' (one id per word), CLIP
        framing — see CLIPBPETokenizer.encode_to_tokens."""
        return (
            ["<|startoftext|>"]
            + [w + "</w>" for w in self._words(text)]
            + ["<|endoftext|>"]
        )

    def decode(self, ids: Sequence[int]) -> str:
        return " ".join(f"<{i}>" for i in ids)

    def __call__(
        self, texts: Sequence[str], max_length: int = CLIP_MAX_LEN,
        padding: str = "max_length",
    ) -> Dict[str, np.ndarray]:
        rows, eos_pos = [], []
        for t in texts:
            ids = self.encode(t)
            if len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.eos_token_id]
            eos_pos.append(len(ids) - 1)
            rows.append(ids)
        L = max_length if padding == "max_length" else max(len(r) for r in rows)
        out = np.full((len(rows), L), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(rows), L), dtype=np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return {
            "input_ids": out,
            "eos_positions": np.asarray(eos_pos, dtype=np.int32),
            "attention_mask": mask,
        }


def load_clip_tokenizer(model_dir: Optional[str] = None,
                        pad_token_id: Optional[int] = None):
    """CLIP tokenizer from a local HF snapshot dir, else HashTokenizer.

    `pad_token_id=0` builds the SDXL tokenizer_2 variant (same
    vocab/merges, "!"-id-0 padding)."""
    if model_dir:
        v = os.path.join(model_dir, "vocab.json")
        m = os.path.join(model_dir, "merges.txt")
        if os.path.exists(v) and os.path.exists(m):
            return CLIPBPETokenizer(v, m, pad_token_id=pad_token_id)
    return HashTokenizer(49408, pad_token_id=pad_token_id)
