"""The plain host half (`reference.host`) against the program's own on the
CPU: CLIP's byte-pair encoding over the benchmark's vocabulary, the
caption batch, and Grounded-SAM's host decode on drawn detector outputs,
with boxes that pass the thresholds and ones that do not."""

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import host
from benchmark.tests.tiny import REPO


@pytest.fixture(scope="module")
def corpus():
    return inputs.read_lines(f"{REPO}/collected_data/abc5k.txt")[:400]


def test_bpe_and_captions_match_the_program(tmp_path, corpus):
    from comat_tpu_torch.losses.caption_reward import build_caption_batch
    from comat_tpu_torch.text.tokenizer import HashTokenizer, load_clip_tokenizer

    folder = inputs.write_byte_vocab(str(tmp_path), corpus, 200, 49408)
    prog, plain = load_clip_tokenizer(folder), host.ClipBPE(folder)
    texts = corpus[:64] + ["", "A  red &amp; blue CAR, 2 dogs!", " ".join(corpus[:8])]
    enc = prog(texts, max_length=77)
    rows = [plain.row(t, 77) for t in texts]
    assert np.array_equal(enc["input_ids"], [r for r, _ in rows])
    assert np.array_equal(enc["eos_positions"], [e for _, e in rows])
    cap = build_caption_batch(HashTokenizer(30524), corpus[:4])
    want = host.captions(corpus[:4], 30524)
    n = cap["input_ids"].shape[1]
    assert np.array_equal(cap["input_ids"], want["caption_ids"][:, :n])
    assert np.array_equal(cap["attention_mask"], want["caption_mask"][:, :n])
    assert np.array_equal(cap["labels"], want["caption_labels"][:, :n])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_decode_matches_the_program(seed):
    from comat_tpu_torch.segmentation.fastsam import YoloSegConfig, decode_predictions
    from comat_tpu_torch.segmentation.grounded_sam import GroundedSAMSegmenter
    from comat_tpu_torch.text.tokenizer import HashTokenizer

    g = np.random.default_rng(seed)
    B, H, W, nm, reg, nq, T = 2, 64, 64, 8, 4, 12, 16
    outs = [{"box": g.normal(0, 2, (B, H // s, W // s, 4 * reg)).astype(np.float32),
             "cls": g.normal(-1, 2, (B, H // s, W // s, 1)).astype(np.float32),
             "mc": g.normal(0, 1, (B, H // s, W // s, nm)).astype(np.float32)}
            for s in (8, 16, 32)]
    protos = g.normal(0, 1, (B, H // 4, W // 4, nm)).astype(np.float32)
    boxes = np.concatenate([g.uniform(0.2, 0.8, (B, nq, 2)), g.uniform(0.1, 0.5, (B, nq, 2))],
                           -1).astype(np.float32)
    logits = g.normal(-1.5, 1.5, (B, nq, T)).astype(np.float32)
    nouns = [["red car", "dog"], ["a tree", "blue sky", "cat"]]
    seg = GroundedSAMSegmenter.__new__(GroundedSAMSegmenter)
    seg.tokenizer = HashTokenizer()
    seg.gdino_cfg = type("C", (), {"max_text_len": T})()
    seg.box_threshold, seg.text_threshold = 0.3, 0.25
    rows = [(n,) + seg._tokenize_nouns(n) for n in nouns]
    props = decode_predictions([{k: torch.from_numpy(v) for k, v in o.items()} for o in outs],
                               torch.from_numpy(protos), YoloSegConfig(num_masks=nm, reg_max=reg))
    got = seg.decode_masks(rows, boxes, logits, props, H, W)
    want = host.decode_masks(nouns, boxes, logits, outs, protos, H, W, 4)
    assert want.sum() > 0
    for b in range(B):
        for w, m in enumerate(got[b]):
            assert np.array_equal(want[b, w], m.astype(np.uint8)), (b, w)
