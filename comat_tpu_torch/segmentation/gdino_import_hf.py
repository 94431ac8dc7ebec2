"""GroundingDINO from an HF `transformers` snapshot
(IDEA-Research/grounding-dino-tiny).

Port of comat_tpu/segmentation/gdino_import_hf.py (`_RENAMES`, `_PACKS`,
`_DROPS`, `hf_to_gdino_tensors`). The same released weights as
groundingdino_swint_ogc.pth are published as an HF model whose module
names differ; this renames an HF GroundingDino state dict into the IDEA
release's names, which the port's `GroundingDetector` carries, and packs
each HF query/key/value triple into IDEA's `in_proj_weight` /
`in_proj_bias` (torch MultiheadAttention) or Swin's `qkv`, q, k, v in
that order along dim 0. HF's top-level `bbox_embed.N.*` (duplicates of
the decoder's), the pooler and derived buffers are dropped. A key that
no rule covers raises. The snapshot's safetensors are read with the
port's own reader (training/checkpoints.py `load_safetensors`).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

_B = "model.backbone.conv_encoder.model"

# (HF regex, IDEA replacement). Applied first-match. Keys that match no
# rule and no pack/drop rule raise (layout drift must be loud).
_RENAMES = [
    # ---- Swin backbone ----
    (rf"{_B}\.embeddings\.patch_embeddings\.projection\.(weight|bias)",
     r"backbone.0.patch_embed.proj.\1"),
    (rf"{_B}\.embeddings\.norm\.(weight|bias)",
     r"backbone.0.patch_embed.norm.\1"),
    (rf"{_B}\.encoder\.layers\.(\d+)\.blocks\.(\d+)\.attention\.self"
     r"\.relative_position_bias_table",
     r"backbone.0.layers.\1.blocks.\2.attn.relative_position_bias_table"),
    (rf"{_B}\.encoder\.layers\.(\d+)\.blocks\.(\d+)\.attention\.output"
     r"\.dense\.(weight|bias)",
     r"backbone.0.layers.\1.blocks.\2.attn.proj.\3"),
    (rf"{_B}\.encoder\.layers\.(\d+)\.blocks\.(\d+)\.layernorm_before"
     r"\.(weight|bias)",
     r"backbone.0.layers.\1.blocks.\2.norm1.\3"),
    (rf"{_B}\.encoder\.layers\.(\d+)\.blocks\.(\d+)\.layernorm_after"
     r"\.(weight|bias)",
     r"backbone.0.layers.\1.blocks.\2.norm2.\3"),
    (rf"{_B}\.encoder\.layers\.(\d+)\.blocks\.(\d+)\.intermediate\.dense"
     r"\.(weight|bias)",
     r"backbone.0.layers.\1.blocks.\2.mlp.fc1.\3"),
    (rf"{_B}\.encoder\.layers\.(\d+)\.blocks\.(\d+)\.output\.dense"
     r"\.(weight|bias)",
     r"backbone.0.layers.\1.blocks.\2.mlp.fc2.\3"),
    (rf"{_B}\.encoder\.layers\.(\d+)\.downsample\.norm\.(weight|bias)",
     r"backbone.0.layers.\1.downsample.norm.\2"),
    (rf"{_B}\.encoder\.layers\.(\d+)\.downsample\.reduction\.weight",
     r"backbone.0.layers.\1.downsample.reduction.weight"),
    (rf"{_B}\.hidden_states_norms\.stage(\d+)\.(weight|bias)",
     lambda m: f"backbone.0.norm{int(m.group(1)) - 1}.{m.group(2)}"),
    # ---- BERT text tower (names already HF-BERT inside) ----
    (r"model\.text_backbone\.(.+)", r"bert.\1"),
    (r"model\.text_projection\.(weight|bias)", r"feat_map.\1"),
    # ---- input projections / level embed ----
    (r"model\.input_proj_vision\.(\d+)\.([01])\.(weight|bias)",
     r"input_proj.\1.\2.\3"),
    (r"model\.level_embed", "transformer.level_embed"),
    # ---- encoder: fusion ----
    (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.attn\.vision_proj"
     r"\.(weight|bias)",
     r"transformer.encoder.fusion_layers.\1.attn.v_proj.\2"),
    (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.attn\.text_proj"
     r"\.(weight|bias)",
     r"transformer.encoder.fusion_layers.\1.attn.l_proj.\2"),
    (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.attn"
     r"\.values_vision_proj\.(weight|bias)",
     r"transformer.encoder.fusion_layers.\1.attn.values_v_proj.\2"),
    (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.attn"
     r"\.values_text_proj\.(weight|bias)",
     r"transformer.encoder.fusion_layers.\1.attn.values_l_proj.\2"),
    (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.attn"
     r"\.out_vision_proj\.(weight|bias)",
     r"transformer.encoder.fusion_layers.\1.attn.out_v_proj.\2"),
    (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.attn"
     r"\.out_text_proj\.(weight|bias)",
     r"transformer.encoder.fusion_layers.\1.attn.out_l_proj.\2"),
    (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.layer_norm_vision"
     r"\.(weight|bias)",
     r"transformer.encoder.fusion_layers.\1.layer_norm_v.\2"),
    (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.layer_norm_text"
     r"\.(weight|bias)",
     r"transformer.encoder.fusion_layers.\1.layer_norm_l.\2"),
    (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.vision_param",
     r"transformer.encoder.fusion_layers.\1.gamma_v"),
    (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.text_param",
     r"transformer.encoder.fusion_layers.\1.gamma_l"),
    # ---- encoder: text enhancer ----
    (r"model\.encoder\.layers\.(\d+)\.text_enhancer_layer\.self_attn"
     r"\.out_proj\.(weight|bias)",
     r"transformer.encoder.text_layers.\1.self_attn.out_proj.\2"),
    (r"model\.encoder\.layers\.(\d+)\.text_enhancer_layer"
     r"\.layer_norm_before\.(weight|bias)",
     r"transformer.encoder.text_layers.\1.norm1.\2"),
    (r"model\.encoder\.layers\.(\d+)\.text_enhancer_layer"
     r"\.layer_norm_after\.(weight|bias)",
     r"transformer.encoder.text_layers.\1.norm2.\2"),
    (r"model\.encoder\.layers\.(\d+)\.text_enhancer_layer\.fc([12])"
     r"\.(weight|bias)",
     r"transformer.encoder.text_layers.\1.linear\2.\3"),
    # ---- encoder: deformable image layer ----
    (r"model\.encoder\.layers\.(\d+)\.deformable_layer\.self_attn"
     r"\.(sampling_offsets|attention_weights|value_proj|output_proj)"
     r"\.(weight|bias)",
     r"transformer.encoder.layers.\1.self_attn.\2.\3"),
    (r"model\.encoder\.layers\.(\d+)\.deformable_layer"
     r"\.self_attn_layer_norm\.(weight|bias)",
     r"transformer.encoder.layers.\1.norm1.\2"),
    (r"model\.encoder\.layers\.(\d+)\.deformable_layer"
     r"\.final_layer_norm\.(weight|bias)",
     r"transformer.encoder.layers.\1.norm2.\2"),
    (r"model\.encoder\.layers\.(\d+)\.deformable_layer\.fc([12])"
     r"\.(weight|bias)",
     r"transformer.encoder.layers.\1.linear\2.\3"),
    # ---- two-stage query selection ----
    (r"model\.enc_output\.(weight|bias)", r"transformer.enc_output.\1"),
    (r"model\.enc_output_norm\.(weight|bias)",
     r"transformer.enc_output_norm.\1"),
    (r"model\.encoder_output_bbox_embed\.layers\.(\d+)\.(weight|bias)",
     r"transformer.enc_out_bbox_embed.layers.\1.\2"),
    (r"model\.query_position_embeddings\.weight",
     "transformer.tgt_embed.weight"),
    # ---- decoder ----
    (r"model\.decoder\.reference_points_head\.layers\.(\d+)"
     r"\.(weight|bias)",
     r"transformer.decoder.ref_point_head.layers.\1.\2"),
    (r"model\.decoder\.layer_norm\.(weight|bias)",
     r"transformer.decoder.norm.\1"),
    (r"model\.decoder\.layers\.(\d+)\.self_attn\.out_proj\.(weight|bias)",
     r"transformer.decoder.layers.\1.self_attn.out_proj.\2"),
    (r"model\.decoder\.layers\.(\d+)\.self_attn_layer_norm\.(weight|bias)",
     r"transformer.decoder.layers.\1.norm2.\2"),
    (r"model\.decoder\.layers\.(\d+)\.encoder_attn_text\.out_proj"
     r"\.(weight|bias)",
     r"transformer.decoder.layers.\1.ca_text.out_proj.\2"),
    (r"model\.decoder\.layers\.(\d+)\.encoder_attn_text_layer_norm"
     r"\.(weight|bias)",
     r"transformer.decoder.layers.\1.catext_norm.\2"),
    (r"model\.decoder\.layers\.(\d+)\.encoder_attn"
     r"\.(sampling_offsets|attention_weights|value_proj|output_proj)"
     r"\.(weight|bias)",
     r"transformer.decoder.layers.\1.cross_attn.\2.\3"),
    (r"model\.decoder\.layers\.(\d+)\.encoder_attn_layer_norm"
     r"\.(weight|bias)",
     r"transformer.decoder.layers.\1.norm1.\2"),
    (r"model\.decoder\.layers\.(\d+)\.fc([12])\.(weight|bias)",
     r"transformer.decoder.layers.\1.linear\2.\3"),
    (r"model\.decoder\.layers\.(\d+)\.final_layer_norm\.(weight|bias)",
     r"transformer.decoder.layers.\1.norm3.\2"),
    (r"model\.decoder\.bbox_embed\.(\d+)\.layers\.(\d+)\.(weight|bias)",
     r"transformer.decoder.bbox_embed.\1.layers.\2.\3"),
]

# HF q/k/v triples that IDEA packs: (regex with (prefix, index, leaf)
# groups) -> IDEA packed base name format
_PACKS = [
    (rf"{_B}\.encoder\.layers\.(\d+)\.blocks\.(\d+)\.attention\.self"
     r"\.(query|key|value)\.(weight|bias)",
     lambda m: (f"backbone.0.layers.{m.group(1)}.blocks.{m.group(2)}"
                f".attn.qkv.{m.group(4)}", m.group(3), m.group(4))),
    (r"model\.encoder\.layers\.(\d+)\.text_enhancer_layer\.self_attn"
     r"\.(query|key|value)\.(weight|bias)",
     lambda m: (f"transformer.encoder.text_layers.{m.group(1)}"
                f".self_attn.in_proj_{m.group(3)}",
                m.group(2), m.group(3))),
    (r"model\.decoder\.layers\.(\d+)\.self_attn\.(query|key|value)"
     r"\.(weight|bias)",
     lambda m: (f"transformer.decoder.layers.{m.group(1)}"
                f".self_attn.in_proj_{m.group(3)}",
                m.group(2), m.group(3))),
    (r"model\.decoder\.layers\.(\d+)\.encoder_attn_text"
     r"\.(query|key|value)\.(weight|bias)",
     lambda m: (f"transformer.decoder.layers.{m.group(1)}"
                f".ca_text.in_proj_{m.group(3)}",
                m.group(2), m.group(3))),
]

_DROPS = [
    r".*relative_position_index$",
    r".*position_ids$",
    r"^bbox_embed\.\d+\.",        # shared duplicates of decoder heads
    r"^model\.text_backbone\.pooler\.",
]


def hf_to_gdino_tensors(
    state_dict: Dict[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """Rename and repack an HF-transformers GroundingDino state dict
    (numpy arrays or tensors) into the IDEA release's names."""
    out: Dict[str, np.ndarray] = {}
    pending: Dict[str, Dict[str, np.ndarray]] = {}

    for key, val in state_dict.items():
        arr = np.asarray(val)
        if any(re.fullmatch(d, key) or re.match(d, key) for d in _DROPS):
            continue
        packed = False
        for pat, fmt in _PACKS:
            m = re.fullmatch(pat, key)
            if m:
                name, slot, _leaf = fmt(m)
                pending.setdefault(name, {})[slot] = arr
                packed = True
                break
        if packed:
            continue
        for pat, rep in _RENAMES:
            m = re.fullmatch(pat, key)
            if m:
                new = rep(m) if callable(rep) else m.expand(rep)
                out[new] = arr
                break
        else:
            raise KeyError(f"unmapped HF tensor: {key}")

    for name, slots in pending.items():
        missing = {"query", "key", "value"} - set(slots)
        if missing:
            raise KeyError(f"{name}: missing packed slots {missing}")
        out[name] = np.concatenate(
            [slots["query"], slots["key"], slots["value"]], axis=0
        )
    return out


def load_gdino_hf_snapshot(model: nn.Module, snapshot_dir: str
                           ) -> Tuple[List[str], List[str]]:
    """Load a GroundingDetector from a local HF snapshot directory (its
    *.safetensors). Returns (missing, unused) as
    `segmentation.checkpoints.load_into` reports them."""
    from comat_tpu_torch.segmentation.checkpoints import load_into
    from comat_tpu_torch.training.checkpoints import load_safetensors

    sd: Dict[str, np.ndarray] = {}
    for fn in sorted(os.listdir(snapshot_dir)):
        if fn.endswith(".safetensors"):
            sd.update(load_safetensors(os.path.join(snapshot_dir, fn)))
    if not sd:
        raise FileNotFoundError(f"no safetensors in {snapshot_dir}")
    return load_into(model, {k: torch.from_numpy(np.array(v, np.float32))
                             for k, v in hf_to_gdino_tensors(sd).items()})
