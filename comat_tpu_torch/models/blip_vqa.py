"""BLIP-VQA, the T2I-CompBench attribute-binding scorer.

Port of comat_tpu/models/blip_vqa.py (`BLIPVQA`, `encode_fixed`,
`build_answer_batch`). Salesforce/blip-vqa-base's architecture: the
captioner's ViT vision tower, a bidirectional BERT question encoder that
cross-attends the question tokens to the image, and a causal BERT answer
decoder that cross-attends the answer tokens to the encoded question
under the question's padding mask. A candidate answer is scored by its
sequence log-likelihood (the original BLIP repo's `rank_answer`), and the
binding score of a question is

    P(yes) = softmax([loglik("yes" | image, q), loglik("no" | image, q)])[0]
           = sigmoid(loglik("yes") - loglik("no")).

Parameter names are those of transformers' `BlipForQuestionAnswering`
state dict (`vision_model.*`, `text_encoder.*`, `text_decoder.bert.*`,
`text_decoder.cls.predictions.*`), so a snapshot loads with
`load_state_dict` after `hf_import.blip_vqa_from_hf`. The answer
decoder's cross-attention reads the question encoder's states, so its key
and value projections are text-wide. Attention is plain PyTorch, as in
JAX, where no Pallas kernel runs in BLIP.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from comat_tpu_torch.config import BLIPConfig
from comat_tpu_torch.models.blip import BlipTextDecoder, BlipVisionModel, _Bert
from comat_tpu_torch.models.pipeline import resolve_device
from comat_tpu_torch.weights import init_weights_

IGNORE_INDEX = -100


class BLIPVQA(nn.Module):
    """Vision tower, question encoder and answer decoder."""

    def __init__(self, cfg: BLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.vision_model = BlipVisionModel(cfg, device)
        self.text_encoder = _Bert(cfg, device)
        self.text_decoder = BlipTextDecoder(cfg, device,
                                            encoder_width=cfg.text_hidden_size)

    def encode_question(self, q_ids: torch.Tensor, q_mask: torch.Tensor,
                        image_embeds: torch.Tensor) -> torch.Tensor:
        """(B, Sq) ids and 1/0 mask, (B, Sv, Dv) image states -> (B, Sq, D):
        bidirectional self-attention under the key-padding mask, every
        layer attending to every image state."""
        x = self.text_encoder.embeddings(q_ids)
        mask = q_mask.bool()[:, None, None, :]
        for layer in self.text_encoder.encoder.layer:
            x = layer(x, mask, image_embeds)
        return x

    def answer_loglik(self, q_states: torch.Tensor, q_mask: torch.Tensor,
                      a_ids: torch.Tensor, a_labels: torch.Tensor) -> torch.Tensor:
        """(B,) fp32 log-likelihood of each answer: the sum over the shifted
        positions whose label is not IGNORE_INDEX. The decoder is causal
        (no answer padding mask, as in JAX) and cross-attends to the
        question states under the question mask."""
        ones = torch.ones_like(a_ids)
        cross = q_mask.bool()[:, None, None, :]
        logits = self.text_decoder(a_ids, ones, q_states, cross)[:, :-1]
        labels = a_labels[:, 1:].long()
        valid = labels != IGNORE_INDEX
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
        return torch.where(valid, ll, 0.0).sum(-1)

    def answer_logliks(self, pixel_values, q_ids, q_mask, yes_ids, yes_labels,
                       no_ids, no_labels) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ll_yes, ll_no), each (B,): pixel_values (B, H, W, 3)
        CLIP-normalised, the question (B, Sq), the two BOS-led candidates
        and their labels (B, Sa)."""
        img = self.vision_model(pixel_values)
        qs = self.encode_question(q_ids, q_mask, img)
        return (self.answer_loglik(qs, q_mask, yes_ids, yes_labels),
                self.answer_loglik(qs, q_mask, no_ids, no_labels))

    def yes_probability(self, pixel_values, q_ids, q_mask, yes_ids, yes_labels,
                        no_ids, no_labels) -> torch.Tensor:
        """(B,) P(yes) by two-candidate answer ranking."""
        ll_yes, ll_no = self.answer_logliks(pixel_values, q_ids, q_mask, yes_ids,
                                            yes_labels, no_ids, no_labels)
        return torch.sigmoid(ll_yes - ll_no)

    def forward(self, *args):
        return self.yes_probability(*args)


def make_blip_vqa(cfg: BLIPConfig, device=None,
                  params: Optional[Dict[str, torch.Tensor]] = None,
                  seed: int = 0) -> BLIPVQA:
    """BLIP-VQA on `device` (CUDA unless the caller says otherwise), frozen,
    holding `params` (a state dict, as `hf_import.blip_vqa_from_hf` or
    `weights.from_jax_params(...)["blip_vqa"]` makes) or weights drawn from
    `seed` (`weights.init_weights_`; the decoder's LM head then set to its
    word embeddings, as transformers ties them)."""
    device = resolve_device(device)
    with torch.device("meta"):
        vqa = BLIPVQA(cfg)
    vqa = vqa.to_empty(device=device).eval().requires_grad_(False)
    if params is None:
        init_weights_(vqa, torch.Generator(device=device).manual_seed(seed))
        emb = vqa.text_decoder.bert.embeddings.word_embeddings.weight
        with torch.no_grad():
            vqa.text_decoder.cls.predictions.decoder.weight.copy_(emb.float())
    else:
        vqa.load_state_dict(params)
    return vqa


def encode_fixed(tokenizer, texts, length: int) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, mask) int32 at `length` whatever the tokenizer's padding
    (BertWordPieceTokenizer pads to the longest, HashTokenizer to
    max_length): cut, or padded with 0."""
    try:
        enc = tokenizer(texts, max_length=length)
    except TypeError:   # BertWordPieceTokenizer: no max_length keyword
        enc = tokenizer(texts)
    ids = np.asarray(enc["input_ids"])[:, :length]
    mask = np.asarray(enc["attention_mask"])[:, :length]
    if ids.shape[1] < length:
        pad = length - ids.shape[1]
        ids = np.pad(ids, ((0, 0), (0, pad)))
        mask = np.pad(mask, ((0, 0), (0, pad)))
    return ids.astype(np.int32), mask.astype(np.int32)


def build_answer_batch(tokenizer, answers, batch: int, max_length: int = 8,
                       bos_token_id: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, labels) of the first candidate answer, tiled to `batch` rows.
    The leading token is forced to `bos_token_id` ([DEC] = 30522: BLIP's
    rank_answer sets `input_ids[:, 0] = bos_token_id`); the labels are the
    ids where the mask is 1, IGNORE_INDEX elsewhere (the first position is
    never scored: `answer_loglik` shifts)."""
    ids, mask = encode_fixed(tokenizer, answers, max_length)
    ids, mask = ids[:1].copy(), mask[:1]
    if bos_token_id is not None:
        ids[:, 0] = bos_token_id
    labels = np.where(mask > 0, ids, IGNORE_INDEX)
    return np.tile(ids, (batch, 1)), np.tile(labels, (batch, 1)).astype(np.int32)
