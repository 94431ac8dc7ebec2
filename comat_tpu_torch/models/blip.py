"""BLIP image captioner, the frozen concept-matching reward model.

Port of comat_tpu/models/blip.py (`BLIPCaptioner`). A ViT vision encoder
(16x16 patches, CLS token, pre-LN blocks) and a BERT-style causal text
decoder with cross-attention to the vision states and an LM head with its
transform block. `caption_loss` is the shifted cross-entropy of HF
`BlipTextLMHeadModel` (ignore index -100, optional label smoothing), and
is differentiable with respect to the image, through which the reward's
gradient reaches the sampler.

Parameter names are those of transformers' `BlipForConditionalGeneration`
state dict (`vision_model.*`, `text_decoder.bert.*`,
`text_decoder.cls.predictions.*`; the vision q/k/v are one fused `qkv`
projection), without importing transformers. Weights are stored in the
config's dtype, except the LM head, which runs in fp32 as in JAX.
Attention is plain PyTorch (fp32 logits and softmax), as in JAX, where no
Pallas kernel runs in BLIP.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from comat_tpu_torch.config import BLIPConfig
from comat_tpu_torch.models.pipeline import resolve_device
from comat_tpu_torch.weights import init_weights_

IGNORE_INDEX = -100


def _attention(q, k, v, heads: int, mask: Optional[torch.Tensor] = None):
    """(B, Sq, D) x (B, Sk, D) attention with fp32 logits and softmax, the
    probabilities in v's dtype times v; `mask` (B, 1, Sq|1, Sk) bool keeps
    True entries."""
    B, Sq, D = q.shape
    Sk = k.shape[1]
    hd = D // heads

    def split(x, s):
        return x.reshape(B, s, heads, hd).transpose(1, 2)

    logits = torch.matmul(split(q, Sq).float(), split(k, Sk).float().transpose(-1, -2))
    logits = logits / (hd ** 0.5)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype), split(v, Sk))
    return out.transpose(1, 2).reshape(B, Sq, D)


class BlipVisionEmbeddings(nn.Module):
    def __init__(self, cfg: BLIPConfig, device=None):
        super().__init__()
        D, dt = cfg.vision_hidden_size, cfg.dtype
        self.patch_embedding = nn.Conv2d(3, D, cfg.patch_size, stride=cfg.patch_size,
                                         dtype=dt, device=device)
        self.class_embedding = nn.Parameter(torch.empty(1, 1, D, dtype=dt, device=device))
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Parameter(
            torch.empty(1, n_pos, D, dtype=dt, device=device))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, 1 + N, D)."""
        dt = self.patch_embedding.weight.dtype
        x = self.patch_embedding(pixel_values.to(dt).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + self.position_embedding[:, : x.shape[1]]


class BlipAttention(nn.Module):
    def __init__(self, D: int, heads: int, dtype, device=None):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(D, 3 * D, dtype=dtype, device=device)
        self.projection = nn.Linear(D, D, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.projection(_attention(q, k, v, self.heads))


class BlipMLP(nn.Module):
    def __init__(self, D: int, inner: int, dtype, device=None):
        super().__init__()
        self.fc1 = nn.Linear(D, inner, dtype=dtype, device=device)
        self.fc2 = nn.Linear(inner, D, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class BlipEncoderLayer(nn.Module):
    def __init__(self, cfg: BLIPConfig, device=None):
        super().__init__()
        D, dt = cfg.vision_hidden_size, cfg.dtype
        kw = dict(dtype=dt, device=device)
        self.layer_norm1 = nn.LayerNorm(D, eps=1e-5, **kw)
        self.self_attn = BlipAttention(D, cfg.vision_heads, **kw)
        self.layer_norm2 = nn.LayerNorm(D, eps=1e-5, **kw)
        self.mlp = BlipMLP(D, cfg.vision_intermediate_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class BlipEncoder(nn.Module):
    def __init__(self, cfg: BLIPConfig, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [BlipEncoderLayer(cfg, device) for _ in range(cfg.vision_layers)])


class BlipVisionModel(nn.Module):
    def __init__(self, cfg: BLIPConfig, device=None):
        super().__init__()
        self.embeddings = BlipVisionEmbeddings(cfg, device)
        self.encoder = BlipEncoder(cfg, device)
        self.post_layernorm = nn.LayerNorm(cfg.vision_hidden_size, eps=1e-5,
                                           dtype=cfg.dtype, device=device)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values (B, H, W, 3), normalised -> (B, 1 + N, D)."""
        x = self.embeddings(pixel_values)
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x)


class _BertSelf(nn.Module):
    """query/key/value of a BERT attention; key and value read `kv_dim`."""

    def __init__(self, D: int, kv_dim: int, dtype, device=None):
        super().__init__()
        self.query = nn.Linear(D, D, dtype=dtype, device=device)
        self.key = nn.Linear(kv_dim, D, dtype=dtype, device=device)
        self.value = nn.Linear(kv_dim, D, dtype=dtype, device=device)


class _BertOutput(nn.Module):
    """dense, then LayerNorm(x + residual) (post-LN)."""

    def __init__(self, inner: int, D: int, dtype, device=None):
        super().__init__()
        self.dense = nn.Linear(inner, D, dtype=dtype, device=device)
        self.LayerNorm = nn.LayerNorm(D, eps=1e-12, dtype=dtype, device=device)

    def forward(self, h: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(residual + self.dense(h))


class _BertAttention(nn.Module):
    def __init__(self, D: int, kv_dim: int, heads: int, dtype, device=None):
        super().__init__()
        self.heads = heads
        setattr(self, "self", _BertSelf(D, kv_dim, dtype, device))
        self.output = _BertOutput(D, D, dtype, device)

    def forward(self, x, kv, mask=None):
        proj = getattr(self, "self")
        a = _attention(proj.query(x), proj.key(kv), proj.value(kv), self.heads, mask)
        return self.output(a, x)


class _BertIntermediate(nn.Module):
    def __init__(self, D: int, inner: int, dtype, device=None):
        super().__init__()
        self.dense = nn.Linear(D, inner, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(x))


class BlipTextLayer(nn.Module):
    """A BERT layer: self-attention, cross-attention to `enc`, feed-forward,
    each post-LN. The cross-attention's key and value read `encoder_width`
    (HF's `encoder_hidden_size`): the vision width by default, the text
    width where the layer attends to encoded text (BLIP-VQA's answer
    decoder)."""

    def __init__(self, cfg: BLIPConfig, device=None, encoder_width: Optional[int] = None):
        super().__init__()
        D, dt = cfg.text_hidden_size, cfg.dtype
        kv = cfg.vision_hidden_size if encoder_width is None else encoder_width
        self.attention = _BertAttention(D, D, cfg.text_heads, dt, device)
        self.crossattention = _BertAttention(D, kv, cfg.text_heads, dt, device)
        self.intermediate = _BertIntermediate(D, cfg.text_intermediate_size, dt, device)
        self.output = _BertOutput(cfg.text_intermediate_size, D, dt, device)

    def forward(self, x, mask, enc, cross_mask: Optional[torch.Tensor] = None):
        """`mask` (B, 1, S, S) and `cross_mask` (B, 1, S|1, Sk) bool keep
        True entries; no `cross_mask` attends to every key of `enc`."""
        x = self.attention(x, x, mask)
        x = self.crossattention(x, enc.to(x.dtype), cross_mask)
        return self.output(self.intermediate(x), x)


class _BertEmbeddings(nn.Module):
    def __init__(self, cfg: BLIPConfig, device=None):
        super().__init__()
        D, dt = cfg.text_hidden_size, cfg.dtype
        self.word_embeddings = nn.Embedding(cfg.vocab_size, D, dtype=dt, device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, D,
                                                dtype=dt, device=device)
        self.LayerNorm = nn.LayerNorm(D, eps=1e-12, dtype=dt, device=device)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        S = input_ids.shape[1]
        x = self.word_embeddings(input_ids) + self.position_embeddings.weight[:S]
        return self.LayerNorm(x)


class _BertEncoder(nn.Module):
    def __init__(self, cfg: BLIPConfig, device=None, encoder_width: Optional[int] = None):
        super().__init__()
        self.layer = nn.ModuleList([BlipTextLayer(cfg, device, encoder_width)
                                    for _ in range(cfg.text_layers)])


class _Bert(nn.Module):
    """HF's `BlipTextModel` without its pooler: embeddings and layers."""

    def __init__(self, cfg: BLIPConfig, device=None, encoder_width: Optional[int] = None):
        super().__init__()
        self.embeddings = _BertEmbeddings(cfg, device)
        self.encoder = _BertEncoder(cfg, device, encoder_width)


class _PredictionTransform(nn.Module):
    def __init__(self, cfg: BLIPConfig, device=None):
        super().__init__()
        D, dt = cfg.text_hidden_size, cfg.dtype
        self.dense = nn.Linear(D, D, dtype=dt, device=device)
        self.LayerNorm = nn.LayerNorm(D, eps=1e-12, dtype=dt, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(F.gelu(self.dense(x)))


class _Predictions(nn.Module):
    """transform, then the fp32 decoder (HF ties its weight to the word
    embeddings; here it is a weight of its own, loaded like any other)."""

    def __init__(self, cfg: BLIPConfig, device=None):
        super().__init__()
        self.transform = _PredictionTransform(cfg, device)
        self.decoder = nn.Linear(cfg.text_hidden_size, cfg.vocab_size, bias=False,
                                 dtype=torch.float32, device=device)
        self.bias = nn.Parameter(torch.empty(cfg.vocab_size, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.transform(x).float()) + self.bias


class _Cls(nn.Module):
    def __init__(self, cfg: BLIPConfig, device=None):
        super().__init__()
        self.predictions = _Predictions(cfg, device)


class BlipTextDecoder(nn.Module):
    def __init__(self, cfg: BLIPConfig, device=None, encoder_width: Optional[int] = None):
        super().__init__()
        self.bert = _Bert(cfg, device, encoder_width)
        self.cls = _Cls(cfg, device)

    def forward(self, input_ids, attention_mask, image_embeds,
                cross_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S) ids and 1/0 mask, (B, Sv, Dv) encoder states (and their
        key mask `cross_mask`, (B, 1, 1, Sv) bool) -> (B, S, V) fp32
        logits."""
        S = input_ids.shape[1]
        x = self.bert.embeddings(input_ids)
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        mask = causal[None, None] & attention_mask.bool()[:, None, None, :]
        for layer in self.bert.encoder.layer:
            x = layer(x, mask, image_embeds, cross_mask)
        return self.cls.predictions(x)


class BLIPCaptioner(nn.Module):
    """The captioner; `caption_loss` is the reward's entry point."""

    def __init__(self, cfg: BLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.vision_model = BlipVisionModel(cfg, device)
        self.text_decoder = BlipTextDecoder(cfg, device)

    def caption_token_losses(self, pixel_values, input_ids, attention_mask, labels):
        """(per-token loss (B, S - 1), 0 where ignored; valid (B, S - 1)
        bool): the shifted cross-entropy with the config's label
        smoothing."""
        image_embeds = self.vision_model(pixel_values)
        logits = self.text_decoder(input_ids, attention_mask, image_embeds)[:, :-1]
        labels = labels[:, 1:].long()
        valid = labels != IGNORE_INDEX
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
        eps = self.cfg.label_smoothing
        per_tok = (1.0 - eps) * nll - eps * logp.mean(-1) if eps else nll
        return torch.where(valid, per_tok, 0.0), valid

    def caption_loss(
        self,
        pixel_values: torch.Tensor,    # (B, H, W, 3), CLIP-normalised
        input_ids: torch.Tensor,       # (B, S)
        attention_mask: torch.Tensor,  # (B, S) 1/0
        labels: torch.Tensor,          # (B, S), IGNORE_INDEX where masked
        token_count: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Shifted cross-entropy, label smoothing from the config, mean
        over the tokens that are not ignored (summed over them and divided
        by `token_count` where given)."""
        per_tok, valid = self.caption_token_losses(pixel_values, input_ids,
                                                   attention_mask, labels)
        if token_count is None:
            token_count = valid.sum().clamp_min(1)
        return per_tok.sum() / token_count

    def forward(self, pixel_values, input_ids, attention_mask, labels):
        return self.caption_loss(pixel_values, input_ids, attention_mask, labels)


def make_blip(cfg: BLIPConfig, device=None,
              params: Optional[Dict[str, torch.Tensor]] = None,
              seed: int = 0) -> BLIPCaptioner:
    """The captioner on `device` (CUDA unless the caller says otherwise;
    asking for CUDA without a card raises), frozen, holding `params` (a
    state dict, as `weights.from_jax_params` makes under "blip") or
    weights drawn from `seed` (`weights.init_weights_`, the LM head's
    decoder weight then set to the word embeddings)."""
    device = resolve_device(device)
    with torch.device("meta"):
        blip = BLIPCaptioner(cfg)
    blip = blip.to_empty(device=device).eval().requires_grad_(False)
    if params is None:
        init_weights_(blip, torch.Generator(device=device).manual_seed(seed))
        # the LM head tied to the word embeddings, as transformers ties it,
        # so that a snapshot saved without the head (`save_pretrained`
        # drops tied tensors) holds the seeded captioner whole
        emb = blip.text_decoder.bert.embeddings.word_embeddings.weight
        with torch.no_grad():
            blip.text_decoder.cls.predictions.decoder.weight.copy_(emb.float())
    else:
        blip.load_state_dict(params)
    return blip
