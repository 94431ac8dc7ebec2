"""Open-set grounding detector (GroundingDINO) and host-side grounding.

Port of comat_tpu/segmentation/gdino.py (`GDinoConfig`, `MLP`, the sine
embeddings, `inverse_sigmoid`, `BertTextEncoder`, `TextSelfAttnLayer`,
`DeformableEncoderLayer`, `BiAttentionFusion`, `DecoderLayer`,
`_contrastive_logits`, `GroundingDetector`, and the host helpers
`cxcywh_to_xyxy`, `build_text_masks`, `ground_nouns`). The reference
grounds ' . '.join(nouns) to boxes at box/text thresholds 0.3/0.25
(attr_concen_utils/gsam_interface.py:92-100), frozen under no_grad.

  image:  Swin-T (or, for the tiny configs, a 5-conv stack with flax's
          tanh GELU) -> input_proj (1x1 conv + GroupNorm per level, a
          3x3/s2 extra level) -> 4-level pyramid
  text:   BERT (LayerNorm eps 1e-12, exact GELU) with per-phrase
          self-attention masks and position ids -> feat_map
  neck:   per layer: bi-directional fusion, text self-attention,
          deformable image self-attention (ops/deformable_attention.py)
  query:  two-stage selection: top-k encoder positions by max token
          logit -> reference boxes; learned content queries
  head:   decoder layers (self-attention, text cross-attention,
          deformable image cross-attention), per-layer box refinement,
          contrastive token logits

Parameter names are the IDEA `groundingdino_swint_ogc.pth` release's
(comat_tpu/segmentation/gdino_import.py:204-296 lists them): `backbone.0`,
`input_proj.{l}.{0,1}`, `bert.*` (HF BERT), `feat_map`,
`transformer.encoder.{fusion_layers,text_layers,layers}`,
`transformer.decoder.*`, with each torch MultiheadAttention's packed
`in_proj_weight` / `in_proj_bias`. The conv backbone of the tiny configs,
which no release has, sits under `backbone.0.bb.{i}` / `backbone.0.bbn.{i}`.
Images are NHWC, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from comat_tpu_torch.ops.deformable_attention import ms_deformable_attention
from comat_tpu_torch.segmentation.layers import (
    Conv2d,
    Dense,
    Embedding,
    GroupNorm,
    LayerNorm,
    softmax_attention,
)
from comat_tpu_torch.segmentation.swin import SwinBackbone, SwinConfig


@dataclasses.dataclass(frozen=True)
class GDinoConfig:
    hidden: int = 256
    heads: int = 8
    levels: int = 4
    points: int = 4
    enc_layers: int = 6
    dec_layers: int = 6
    num_queries: int = 900
    ffn_dim: int = 2048
    # text tower (BERT-base for the released checkpoint)
    text_hidden: int = 768
    text_heads: int = 12
    text_inter: int = 3072
    text_layers: int = 12
    text_vocab: int = 30522
    text_max_pos: int = 512
    max_text_len: int = 64
    backbone: str = "swin"    # "swin" (GroundingDINO-T) or "conv"
    fusion: bool = True       # bi-directional image<->text fusion
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def swint_ogc() -> "GDinoConfig":
        """Geometry of the released groundingdino_swint_ogc.pth."""
        return GDinoConfig()

    @staticmethod
    def tiny() -> "GDinoConfig":
        return GDinoConfig(
            hidden=32, heads=2, levels=3, points=2, enc_layers=1, dec_layers=1,
            num_queries=20, ffn_dim=64, text_hidden=32, text_heads=2, text_inter=64,
            text_layers=1, text_vocab=1000, text_max_pos=64, max_text_len=16,
            backbone="conv", dtype=torch.float32,
        )

    @staticmethod
    def tiny_swin() -> "GDinoConfig":
        return dataclasses.replace(GDinoConfig.tiny(), backbone="swin")


class MLP(nn.Module):
    """n-layer ReLU MLP (`layers.{i}`); the last layer in fp32."""

    def __init__(self, d_in: int, hidden: int, out: int, n_layers: int,
                 dtype: torch.dtype):
        super().__init__()
        dims = [d_in] + [hidden] * (n_layers - 1)
        self.layers = nn.ModuleList(
            [Dense(dims[i], hidden, dtype=dtype) for i in range(n_layers - 1)]
            + [Dense(dims[-1], out, dtype=torch.float32)])

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


def sine_pos_embed_2d(spatial_shapes: Sequence[Tuple[int, int]], num_feats: int,
                      temperature: float = 20.0) -> np.ndarray:
    """PositionEmbeddingSineHW over a flattened multi-level pyramid, (sum(h*w),
    2*num_feats) fp32: [y-feats, x-feats], each interleaved sin/cos."""
    parts = []
    dim_t = temperature ** (2 * (np.arange(num_feats) // 2) / num_feats)
    for h, w in spatial_shapes:
        ys = (np.arange(h, dtype=np.float32) + 1.0) / h * 2 * math.pi
        xs = (np.arange(w, dtype=np.float32) + 1.0) / w * 2 * math.pi
        pos_y = ys[:, None] / dim_t
        pos_x = xs[:, None] / dim_t
        pos_y = np.stack([np.sin(pos_y[:, 0::2]), np.cos(pos_y[:, 1::2])], axis=2).reshape(h, -1)
        pos_x = np.stack([np.sin(pos_x[:, 0::2]), np.cos(pos_x[:, 1::2])], axis=2).reshape(w, -1)
        grid = np.concatenate([np.broadcast_to(pos_y[:, None, :], (h, w, num_feats)),
                               np.broadcast_to(pos_x[None, :, :], (h, w, num_feats))], axis=-1)
        parts.append(grid.reshape(h * w, 2 * num_feats))
    return np.concatenate(parts, 0).astype(np.float32)


def sine_box_embed(boxes: torch.Tensor, num_feats: int,
                   temperature: float = 10000.0) -> torch.Tensor:
    """4-d box (cx, cy, w, h) -> (..., 4*num_feats) in the order (y, x, w, h),
    each coordinate interleaved sin/cos (gen_sineembed_for_position)."""
    dim_t = temperature ** (2 * (torch.arange(num_feats, device=boxes.device) // 2)
                            / num_feats)

    def embed(coord):
        p = coord[..., None] * 2 * math.pi / dim_t
        return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                           dim=-1).reshape(p.shape[:-1] + (num_feats,))

    cx, cy, w, h = boxes.float().unbind(-1)
    return torch.cat([embed(cy), embed(cx), embed(w), embed(h)], dim=-1)


def _sine_pos_1d(n: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    """Sine embedding of token indices 0..n-1, (n, dim) fp32."""
    dim_t = temperature ** (2 * (np.arange(dim) // 2) / dim)
    p = (np.arange(n, dtype=np.float32)[:, None] * 2 * math.pi) / dim_t
    return np.stack([np.sin(p[:, 0::2]), np.cos(p[:, 1::2])], axis=2).reshape(n, dim) \
        .astype(np.float32)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


class PackedMHA(nn.Module):
    """torch MultiheadAttention's parameters (`in_proj_weight` (3D, D)
    holding q, k, v; `out_proj`), JAX's attention over them."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads, self.compute_dtype = heads, dtype
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Dense(dim, dim, dtype=dtype)

    def project(self, x: torch.Tensor, slot: int) -> torch.Tensor:
        D, dt = self.in_proj_weight.shape[1], self.compute_dtype
        w = self.in_proj_weight[slot * D:(slot + 1) * D].to(dt)
        return F.linear(x.to(dt), w, self.in_proj_bias[slot * D:(slot + 1) * D].to(dt))

    def forward(self, q_in, k_in, v_in, key_mask: Optional[torch.Tensor] = None):
        """key_mask (B, Skv) keeps where True. Returns out_proj(attention)."""
        B, Sq, D = q_in.shape
        dh = D // self.heads
        split = lambda a: a.reshape(B, a.shape[1], self.heads, dh).transpose(1, 2)  # noqa: E731
        mask = None if key_mask is None else key_mask[:, None, None, :]
        o = softmax_attention(split(self.project(q_in, 0)), split(self.project(k_in, 1)),
                              split(self.project(v_in, 2)), mask)
        return self.out_proj(o.transpose(1, 2).reshape(B, Sq, D))


# ---- text tower (HF BERT names) ----

class _BertSelf(nn.Module):
    def __init__(self, D: int, dtype):
        super().__init__()
        self.query = Dense(D, D, dtype=dtype)
        self.key = Dense(D, D, dtype=dtype)
        self.value = Dense(D, D, dtype=dtype)


class _BertOut(nn.Module):
    def __init__(self, d_in: int, D: int, dtype):
        super().__init__()
        self.dense = Dense(d_in, D, dtype=dtype)
        self.LayerNorm = LayerNorm(D, eps=1e-12, dtype=dtype)


class _BertAttention(nn.Module):
    def __init__(self, D: int, dtype):
        super().__init__()
        self.self = _BertSelf(D, dtype)
        self.output = _BertOut(D, D, dtype)


class _BertInter(nn.Module):
    def __init__(self, D: int, inter: int, dtype):
        super().__init__()
        self.dense = Dense(D, inter, dtype=dtype)


class BertLayer(nn.Module):
    """Post-norm BERT encoder layer."""

    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        D, dt = cfg.text_hidden, cfg.dtype
        self.heads = cfg.text_heads
        self.attention = _BertAttention(D, dt)
        self.intermediate = _BertInter(D, cfg.text_inter, dt)
        self.output = _BertOut(cfg.text_inter, D, dt)

    def forward(self, x, attn_mask):
        B, S, D = x.shape
        dh = D // self.heads
        a = self.attention
        split = lambda t: t.reshape(B, S, self.heads, dh).transpose(1, 2)  # noqa: E731
        o = softmax_attention(split(a.self.query(x)), split(a.self.key(x)),
                              split(a.self.value(x)), attn_mask[:, None])
        o = o.transpose(1, 2).reshape(B, S, D)
        x = a.output.LayerNorm(x + a.output.dense(o))
        h = self.output.dense(F.gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(x + h)


class _BertEmbeddings(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        D, dt = cfg.text_hidden, cfg.dtype
        self.word_embeddings = Embedding(cfg.text_vocab, D, dtype=dt)
        self.position_embeddings = Embedding(cfg.text_max_pos, D, dtype=dt)
        self.token_type_embeddings = Embedding(2, D, dtype=dt)
        self.LayerNorm = LayerNorm(D, eps=1e-12, dtype=dt)


class _BertEncoder(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(cfg) for _ in range(cfg.text_layers)])


class BertTextEncoder(nn.Module):
    """BERT with GroundingDINO's per-phrase self-attention masks and
    position ids (made on the host by `build_text_masks`)."""

    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        self.embeddings = _BertEmbeddings(cfg)
        self.encoder = _BertEncoder(cfg)

    def forward(self, ids, attn_mask, position_ids):
        e = self.embeddings
        t = (e.word_embeddings(ids) + e.position_embeddings(position_ids)
             + e.token_type_embeddings(torch.zeros_like(ids)))
        t = e.LayerNorm(t)
        for layer in self.encoder.layer:
            t = layer(t, attn_mask)
        return t


# ---- feature enhancer ----

class TextSelfAttnLayer(nn.Module):
    """Post-norm text self-attention (transformer.encoder.text_layers.{i}):
    nhead//2 heads, a dim_feedforward//2 FFN."""

    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        D, dt = cfg.hidden, cfg.dtype
        self.self_attn = PackedMHA(D, max(cfg.heads // 2, 1), dt)
        self.norm1 = LayerNorm(D, dtype=dt)
        self.linear1 = Dense(D, max(cfg.ffn_dim // 2, 1), dtype=dt)
        self.linear2 = Dense(max(cfg.ffn_dim // 2, 1), D, dtype=dt)
        self.norm2 = LayerNorm(D, dtype=dt)

    def forward(self, x, mask, pos_text):
        hp = x + pos_text.to(x.dtype)     # with_pos_embed (q and k only)
        x = self.norm1(x + self.self_attn(hp, hp, x, mask))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class MSDeformAttn(nn.Module):
    """Deformable attention's projections (sampling_offsets and
    attention_weights in fp32, value_proj, output_proj)."""

    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        D, dt = cfg.hidden, cfg.dtype
        n = cfg.heads * cfg.levels * cfg.points
        self.cfg = cfg
        self.sampling_offsets = Dense(D, n * 2, dtype=torch.float32)
        self.attention_weights = Dense(D, n, dtype=torch.float32)
        self.value_proj = Dense(D, D, dtype=dt)
        self.output_proj = Dense(D, D, dtype=dt)

    def offsets_and_weights(self, query):
        c = self.cfg
        B, S, _ = query.shape
        off = self.sampling_offsets(query).reshape(B, S, c.heads, c.levels, c.points, 2)
        w = torch.softmax(self.attention_weights(query).reshape(
            B, S, c.heads, c.levels * c.points), dim=-1)
        return off, w.reshape(B, S, c.heads, c.levels, c.points)

    def value(self, src):
        B, S, D = src.shape
        return self.value_proj(src).reshape(B, S, self.cfg.heads, D // self.cfg.heads)


class DeformableEncoderLayer(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        D, dt = cfg.hidden, cfg.dtype
        self.self_attn = MSDeformAttn(cfg)
        self.norm1 = LayerNorm(D, dtype=dt)
        self.linear1 = Dense(D, cfg.ffn_dim, dtype=dt)
        self.linear2 = Dense(cfg.ffn_dim, D, dtype=dt)
        self.norm2 = LayerNorm(D, dtype=dt)

    def forward(self, src, pos, ref_points, spatial_shapes):
        qsrc = src + pos.to(src.dtype)
        off, w = self.self_attn.offsets_and_weights(qsrc)
        norms = torch.tensor([[wd, ht] for ht, wd in spatial_shapes], dtype=torch.float32,
                             device=src.device)
        locs = ref_points[:, :, None, None, None, :] + off / norms[None, None, None, :, None, :]
        attn = ms_deformable_attention(self.self_attn.value(src), spatial_shapes, locs, w)
        src = self.norm1(src + self.self_attn.output_proj(attn))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class _BiAttn(nn.Module):
    def __init__(self, D: int, E: int, dtype):
        super().__init__()
        self.v_proj = Dense(D, E, dtype=dtype)
        self.l_proj = Dense(D, E, dtype=dtype)
        self.values_v_proj = Dense(D, E, dtype=dtype)
        self.values_l_proj = Dense(D, E, dtype=dtype)
        self.out_v_proj = Dense(E, D, dtype=dtype)
        self.out_l_proj = Dense(E, D, dtype=dtype)


class BiAttentionFusion(nn.Module):
    """Bi-directional image<->text cross-attention (BiAttentionBlock):
    pre-layernorms, shared logits (clamped to +-50000), residual gates
    gamma_v / gamma_l on the normed streams; embed dim dim_feedforward//2,
    nhead//2 heads."""

    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        D, dt = cfg.hidden, cfg.dtype
        self.cfg = cfg
        self.E = max(cfg.ffn_dim // 2, cfg.hidden)
        self.heads = max(cfg.heads // 2, 1)
        self.layer_norm_v = LayerNorm(D, dtype=dt)
        self.layer_norm_l = LayerNorm(D, dtype=dt)
        self.attn = _BiAttn(D, self.E, dt)
        self.gamma_v = nn.Parameter(torch.full((D,), 0.125))
        self.gamma_l = nn.Parameter(torch.full((D,), 0.125))

    def forward(self, img, text, text_mask):
        B, S, _ = img.shape
        T = text.shape[1]
        E, heads = self.E, self.heads
        dh = E // heads
        a = self.attn
        vi = self.layer_norm_v(img)
        li = self.layer_norm_l(text)
        split = lambda t, n: t.reshape(B, n, heads, dh).transpose(1, 2)  # noqa: E731
        q_i, k_t = split(a.v_proj(vi), S), split(a.l_proj(li), T)
        v_t, v_i = split(a.values_l_proj(li), T), split(a.values_v_proj(vi), S)
        logits = torch.matmul(q_i.float(), k_t.float().transpose(-1, -2)) / dh ** 0.5
        logits = logits.clamp(-50000.0, 50000.0)
        masked = torch.where(text_mask[:, None, None, :], logits,
                             torch.full_like(logits, -1e30))
        i2t = torch.matmul(torch.softmax(masked, -1).to(v_t.dtype), v_t)
        t2i = torch.matmul(torch.softmax(logits.transpose(-1, -2), -1).to(v_i.dtype), v_i)
        i2t = i2t.transpose(1, 2).reshape(B, S, E)
        t2i = t2i.transpose(1, 2).reshape(B, T, E)
        img = vi + self.gamma_v.to(img.dtype) * a.out_v_proj(i2t)
        text = li + self.gamma_l.to(text.dtype) * a.out_l_proj(t2i)
        return img, text


class _Encoder(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        n = cfg.enc_layers
        if cfg.fusion:
            self.fusion_layers = nn.ModuleList([BiAttentionFusion(cfg) for _ in range(n)])
        self.text_layers = nn.ModuleList([TextSelfAttnLayer(cfg) for _ in range(n)])
        self.layers = nn.ModuleList([DeformableEncoderLayer(cfg) for _ in range(n)])


class DecoderLayer(nn.Module):
    """Query self-attention, text cross-attention, deformable image
    cross-attention scaled by the reference box (transformer.decoder.layers.{i})."""

    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        D, dt = cfg.hidden, cfg.dtype
        self.cfg = cfg
        self.self_attn = PackedMHA(D, cfg.heads, dt)
        self.norm2 = LayerNorm(D, dtype=dt)
        self.ca_text = PackedMHA(D, cfg.heads, dt)
        self.catext_norm = LayerNorm(D, dtype=dt)
        self.cross_attn = MSDeformAttn(cfg)
        self.norm1 = LayerNorm(D, dtype=dt)
        self.linear1 = Dense(D, cfg.ffn_dim, dtype=dt)
        self.linear2 = Dense(cfg.ffn_dim, D, dtype=dt)
        self.norm3 = LayerNorm(D, dtype=dt)

    def forward(self, q, query_pos, text, text_mask, src, ref_boxes, spatial_shapes):
        c = self.cfg
        src_value = self.cross_attn.value(src)
        qp = query_pos.to(q.dtype)
        q = self.norm2(q + self.self_attn(q + qp, q + qp, q))
        q = self.catext_norm(q + self.ca_text(q + qp, text, text, text_mask))
        off, w = self.cross_attn.offsets_and_weights(q + qp)
        center = ref_boxes[:, :, None, None, None, :2]
        wh = ref_boxes[:, :, None, None, None, 2:]
        locs = center + off / c.points * wh * 0.5
        da = ms_deformable_attention(src_value, spatial_shapes, locs, w)
        q = self.norm1(q + self.cross_attn.output_proj(da))
        return self.norm3(q + self.linear2(F.relu(self.linear1(q))))


class _Decoder(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        D, dt = cfg.hidden, cfg.dtype
        self.layers = nn.ModuleList([DecoderLayer(cfg) for _ in range(cfg.dec_layers)])
        self.ref_point_head = MLP(2 * D, D, D, 2, dt)
        self.norm = LayerNorm(D, dtype=dt)
        self.bbox_embed = nn.ModuleList([MLP(D, D, 4, 3, dt)
                                         for _ in range(cfg.dec_layers)])


class _Transformer(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        D, dt = cfg.hidden, cfg.dtype
        self.level_embed = nn.Parameter(torch.zeros(cfg.levels, D))
        self.encoder = _Encoder(cfg)
        self.enc_output = Dense(D, D, dtype=dt)
        self.enc_output_norm = LayerNorm(D, dtype=dt)
        self.enc_out_bbox_embed = MLP(D, D, 4, 3, dt)
        self.tgt_embed = nn.Embedding(cfg.num_queries, D)
        self.decoder = _Decoder(cfg)


def _contrastive_logits(q, text, text_mask):
    """ContrastiveEmbed: raw fp32 dot products, masked with -1e30."""
    logits = torch.matmul(q.float(), text.float().transpose(-1, -2))
    return torch.where(text_mask[:, None, :], logits, torch.full_like(logits, -1e30))


class ConvBackbone(nn.Module):
    """The tiny configs' stand-in for Swin: 5 stride-2 3x3 convs, each with
    GroupNorm and flax's default (tanh) GELU; maps at strides 8/16/32."""

    def __init__(self, ch: int, dtype):
        super().__init__()
        self.bb = nn.ModuleList([Conv2d(3 if i == 0 else ch, ch, 3, stride=2, padding=1,
                                        dtype=dtype) for i in range(5)])
        self.bbn = nn.ModuleList([GroupNorm(min(8, ch), ch, dtype=dtype) for _ in range(5)])

    def forward(self, image):
        x = image.permute(0, 3, 1, 2)
        stages = []
        for i, (conv, norm) in enumerate(zip(self.bb, self.bbn)):
            x = F.gelu(norm(conv(x)), approximate="tanh")
            if i >= 2:
                stages.append(x.permute(0, 2, 3, 1))
        return stages


class GroundingDetector(nn.Module):
    """(image NHWC, text tokens) -> (boxes cxcywh in [0, 1] (B, Nq, 4) fp32,
    per-token grounding logits (B, Nq, T) fp32)."""

    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.hidden, cfg.dtype
        if cfg.backbone == "swin":
            swin = SwinConfig(dtype=dt) if D >= 256 else SwinConfig.tiny_test()
            self.backbone = nn.ModuleList([SwinBackbone(swin)])
            chans = [swin.embed_dim * 2 ** i for i in (1, 2, 3)]
        else:
            self.backbone = nn.ModuleList([ConvBackbone(D, dt)])
            chans = [D] * 3
        n_bb = min(len(chans), cfg.levels)
        groups = 32 if D % 32 == 0 else 1
        self.input_proj = nn.ModuleList(
            [nn.Sequential(Conv2d(chans[i], D, 1, dtype=dt), GroupNorm(groups, D, dtype=dt))
             for i in range(n_bb)]
            + [nn.Sequential(Conv2d(chans[n_bb - 1], D, 3, stride=2, padding=1, dtype=dt),
                             GroupNorm(groups, D, dtype=dt))
               for _ in range(n_bb, cfg.levels)])
        self.bert = BertTextEncoder(cfg)
        self.feat_map = Dense(cfg.text_hidden, D, dtype=dt)
        self.transformer = _Transformer(cfg)

    def forward(self, image, text_ids, text_mask, text_self_mask=None, position_ids=None,
                top_idx: Optional[torch.Tensor] = None, return_selection: bool = False):
        """`top_idx` (B, k), when given, replaces the two-stage selection's
        top-k positions, so that two runs can be held to one selection
        where their scores tie within rounding. `return_selection` adds a
        third output: (scores (B, S), the max token logit of each encoder
        position, and the top_idx used)."""
        c = self.cfg
        dt, D = c.dtype, c.hidden
        dev = image.device
        B, T = text_ids.shape
        text_ids = text_ids.long()
        text_mask = text_mask.bool()
        if text_self_mask is None:
            text_self_mask = text_mask[:, None, :] & text_mask[:, :, None]
        if position_ids is None:
            position_ids = torch.arange(T, device=dev)[None].expand(B, T)
        tr = self.transformer

        # image pyramid
        stages = self.backbone[0](image.to(dt))
        n_bb = min(len(stages), c.levels)
        feats = [self.input_proj[i](stages[min(i, n_bb - 1)].permute(0, 3, 1, 2))
                 for i in range(c.levels)]
        spatial_shapes = tuple((f.shape[2], f.shape[3]) for f in feats)
        src = torch.cat([f.permute(0, 2, 3, 1).reshape(B, -1, D) for f in feats], dim=1)
        lvl_idx = torch.cat([torch.full((h * w,), l, dtype=torch.long, device=dev)
                             for l, (h, w) in enumerate(spatial_shapes)])
        refs = []
        for h, w in spatial_shapes:
            ys, xs = torch.meshgrid((torch.arange(h, device=dev) + 0.5) / h,
                                    (torch.arange(w, device=dev) + 0.5) / w, indexing="ij")
            refs.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1))
        pos = torch.from_numpy(sine_pos_embed_2d(spatial_shapes, D // 2)).to(dev)
        pos = (pos + tr.level_embed[lvl_idx])[None]
        ref_points = torch.cat(refs, 0)[None].expand(B, -1, -1).float()

        # text tower
        t = self.feat_map(self.bert(text_ids, text_self_mask.bool(), position_ids.long()))

        # feature enhancer
        pos_text = torch.from_numpy(_sine_pos_1d(T, D)).to(dev)[None]
        enc = tr.encoder
        for i in range(c.enc_layers):
            if c.fusion:
                src, t = enc.fusion_layers[i](src, t, text_mask)
            t = enc.text_layers[i](t, text_mask, pos_text)
            src = enc.layers[i](src, pos, ref_points, spatial_shapes)

        # two-stage query selection
        mem = tr.enc_output_norm(tr.enc_output(src))
        scales = torch.cat([torch.full((h * w, 2), 0.05 * (2.0 ** l), device=dev)
                            for l, (h, w) in enumerate(spatial_shapes)])
        proposals = torch.cat([ref_points, scales[None].expand(B, -1, -1)], dim=-1)
        sel_score = _contrastive_logits(mem, t, text_mask).amax(-1)
        k = min(c.num_queries, sel_score.shape[1])
        if top_idx is None:
            top_idx = torch.topk(sel_score, k, dim=1).indices
        sel_mem = torch.gather(mem, 1, top_idx[..., None].expand(-1, -1, D))
        sel_prop = torch.gather(proposals, 1, top_idx[..., None].expand(-1, -1, 4))
        qr = torch.sigmoid(tr.enc_out_bbox_embed(sel_mem) + inverse_sigmoid(sel_prop))
        if k < c.num_queries:
            qr = F.pad(qr, (0, 0, 0, c.num_queries - k), value=0.5)
        q = tr.tgt_embed.weight[None].to(dt).expand(B, -1, -1)

        # decoder with iterative box refinement
        dec = tr.decoder
        qr = qr.clamp(1e-4, 1 - 1e-4)
        normed = q
        for i in range(c.dec_layers):
            query_pos = dec.ref_point_head(sine_box_embed(qr, D // 2))
            q = dec.layers[i](q, query_pos, t, text_mask, src, qr, spatial_shapes)
            normed = dec.norm(q)
            delta = dec.bbox_embed[i](normed)
            qr = torch.sigmoid(delta + inverse_sigmoid(qr)).clamp(1e-4, 1 - 1e-4)
        logits = _contrastive_logits(normed, t, text_mask)
        if return_selection:
            return qr, logits, (sel_score, top_idx)
        return qr, logits


def cxcywh_to_xyxy(boxes: np.ndarray, img_w: float = 1.0, img_h: float = 1.0) -> np.ndarray:
    """Normalised cxcywh -> xyxy, optionally scaled to pixel coordinates."""
    cx, cy, w, h = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    return np.stack([(cx - w / 2) * img_w, (cy - h / 2) * img_h,
                     (cx + w / 2) * img_w, (cy + h / 2) * img_h], axis=-1)


def build_text_masks(ids: np.ndarray, special_ids: Sequence[int]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """GroundingDINO's generate_masks_with_special_tokens_and_transfer_map:
    tokens attend within their '.'-separated phrase, special tokens to
    themselves, position ids restart after each special token. ids (B, T)
    -> (self_mask (B, T, T) bool, position_ids (B, T) int32)."""
    B, T = ids.shape
    special = np.isin(ids, np.asarray(list(special_ids)))
    mask = np.zeros((B, T, T), bool)
    pos = np.zeros((B, T), np.int64)
    idx = np.arange(T)
    mask[:, idx, idx] = True
    for b in range(B):
        prev = 0
        for i in range(T):
            if special[b, i]:
                mask[b, prev:i + 1, prev:i + 1] = True
                pos[b, prev:i + 1] = np.arange(0, i + 1 - prev)
                prev = i + 1
        if prev < T:
            mask[b, prev:T, prev:T] = True
            pos[b, prev:T] = np.arange(0, T - prev)
    return mask, pos.astype(np.int32)


def ground_nouns(boxes: np.ndarray, token_logits: np.ndarray,
                 noun_spans: List[Tuple[int, int]], box_threshold: float = 0.3,
                 text_threshold: float = 0.25) -> Dict[int, List[np.ndarray]]:
    """Assign boxes (Nq, 4) to nouns by their token logits (Nq, T): a box
    whose max token probability passes box_threshold goes to each noun
    whose span's max passes text_threshold (gsam_interface.py:92-116)."""
    probs = np.where(
        token_logits >= 0,
        1.0 / (1.0 + np.exp(-np.clip(token_logits, 0, None))),
        np.exp(np.clip(token_logits, None, 0)) / (1.0 + np.exp(np.clip(token_logits, None, 0))),
    )
    scores = probs.max(-1)
    out: Dict[int, List[np.ndarray]] = {}
    for i in range(len(boxes)):
        if scores[i] < box_threshold:
            continue
        for ni, (a, b) in enumerate(noun_spans):
            span = probs[i, a:b]
            if span.size and span.max() > text_threshold:
                out.setdefault(ni, []).append(boxes[i])
    return out
