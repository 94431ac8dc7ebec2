"""The port's copies of the attribute-concentration host code
(comat_tpu_torch/text/{miniparse,linguistics,parse_cache}.py,
segmentation/interface.py, training/attrcon.attrcon_batch_fields) give
what the JAX package's give, exactly: they are copies, and these are
host-side integer and string results.

- the hand-transcribed goldens of tests/test_linguistics_golden.py;
- the 200 corpus prompts of data/parse_sample_200.txt, parsed by the
  rule-based parser and by the manual parse cache
  (data/parse_cache_manual_200.jsonl): identical attribute groups;
- the batch fields and the masks of both segmenters: identical arrays.
"""

import os

import numpy as np
import pytest

from test_linguistics_golden import GOLDEN

from comat_tpu.segmentation import interface as jseg
from comat_tpu.text import linguistics as jling
from comat_tpu.text import parse_cache as jcache
from comat_tpu.text.tokenizer import HashTokenizer as JHash
from comat_tpu.training.attrcon import attrcon_batch_fields as jfields
from comat_tpu_torch.segmentation import interface as tseg
from comat_tpu_torch.text import linguistics as tling
from comat_tpu_torch.text import parse_cache as tcache
from comat_tpu_torch.text.tokenizer import HashTokenizer
from comat_tpu_torch.training.attrcon import attrcon_batch_fields

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "parse_sample_200.txt")
CACHE = os.path.join(REPO, "data", "parse_cache_manual_200.jsonl")
TOK = HashTokenizer(1000)


def _groups(ling, prompt, tok):
    return [(g.attribute_words, g.noun, g.token_indices)
            for g in ling.extract_attribute_groups(prompt, tok)]


def _prompts():
    with open(CORPUS) as f:
        return [line.strip() for line in f if line.strip()]


@pytest.mark.parametrize("prompt,want_pairs,want_groups", GOLDEN,
                         ids=[p[:40] for p, _, _ in GOLDEN])
def test_golden(prompt, want_pairs, want_groups):
    pairs = [[t.text for t in p] for p in tling.extract_attribution_pairs(prompt)]
    assert pairs == want_pairs
    assert _groups(tling, prompt, TOK) == want_groups


@pytest.mark.parametrize("cached", [False, True], ids=["miniparse", "manual_cache"])
def test_corpus_groups_equal_jax(cached):
    prompts = _prompts()
    assert len(prompts) == 200
    tok, jtok = HashTokenizer(49408), JHash(49408)
    if cached:
        tcache.set_parse_cache(tcache.load_parse_cache(CACHE))
        jcache.set_parse_cache(jcache.load_parse_cache(CACHE))
    try:
        got = [_groups(tling, p, tok) for p in prompts]
        want = [_groups(jling, p, jtok) for p in prompts]
    finally:
        tcache.set_parse_cache(None)
        jcache.set_parse_cache(None)
    assert got == want
    assert sum(map(len, got)) > 100


def test_parse_cache_round_trip():
    cache = tcache.load_parse_cache(CACHE)
    for prompt in _prompts()[:20]:
        doc = tcache.doc_from_record(cache[prompt])
        again = tcache.serialize_doc(doc)["tokens"]
        assert again == cache[prompt]["tokens"]


@pytest.mark.parametrize("segmenter", ["center", "precomputed"])
def test_batch_fields_and_masks_equal_jax(segmenter, tmp_path):
    prompts = ["a red car and a blue bird", "two green cats on a mat",
               "a small wooden table next to a tall black lamp", "a dog"]
    if segmenter == "center":
        ours, theirs = tseg.CenterPriorSegmenter(), jseg.CenterPriorSegmenter()
    else:
        rng = np.random.default_rng(0)
        store = {n: (rng.random((48, 48)) > 0.5).astype(np.float32)
                 for n in ("car", "bird", "table", "lamp")}
        store["cats"] = (rng.random((96, 96)) > 0.5).astype(np.float32)
        path = str(tmp_path / "masks.npz")
        np.savez(path, **store)
        ours, theirs = tseg.PrecomputedMaskSegmenter(path), jseg.PrecomputedMaskSegmenter(path)
    holder, jholder = tseg.SegmenterHolder(ours, 4), jseg.SegmenterHolder(theirs, 4)
    got = attrcon_batch_fields(prompts, HashTokenizer(1000), holder, 77, resolution=96)
    want = jfields(prompts, JHash(1000), jholder, 77, resolution=96)
    assert set(got) == set(want) == {"token_idx", "token_valid", "word_valid", "seg_masks"}
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert holder.nouns == jholder.nouns and got["seg_masks"].any()
