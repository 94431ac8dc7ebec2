"""Weights for the port: carried across from a JAX parameter tree, or
made from a seed.

`from_jax_params` is the port's own copy of the name mapping of
comat_tpu/models/hf_import.py (`_unet_hf_name`, `_clip_hf_name`,
`_vae_hf_name`, `_blip_hf_name`) and of the segmentation importers
(comat_tpu/segmentation/gdino_import.py, weights_import.py), read from
them and not imported. Layouts
change on the way: conv kernels HWIO -> OIHW, dense kernels (in, out) ->
(out, in), the GEGLU kernel (dim, 2, 4*dim) -> diffusers' flat (8*dim,
dim), values first, then gates, and BLIP's separate vision q, k, v ->
transformers' fused `qkv`. LoRA factors `lora_a` (in, r) / `lora_b`
(r, out) keep the JAX layout.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _dense(x):
    return np.asarray(x).T


def _conv(x):  # HWIO -> OIHW
    return np.transpose(np.asarray(x), (3, 2, 0, 1))


def _same(x):
    return np.asarray(x)


def _geglu(x):
    x = np.asarray(x)
    if x.ndim == 3:                      # kernel (dim, 2, 4*dim)
        return x.reshape(x.shape[0], -1).T
    return x.reshape(-1)                 # bias (2, 4*dim)


Rule = Tuple[str, Callable]


def _leaf(kind: str, leaf: str) -> Rule:
    """Torch leaf name and transform for a JAX leaf of a layer `kind`."""
    if kind == "norm":
        return ("weight" if leaf == "scale" else "bias"), _same
    if leaf in ("lora_a", "lora_b"):
        return leaf, _same
    fn = {"dense": _dense, "conv": _conv, "geglu": _geglu}[kind]
    if leaf == "kernel":
        return "weight", fn
    return "bias", (_geglu if kind == "geglu" else _same)


def _unet_rule(path: Tuple[str, ...]) -> Optional[Rule]:
    top, leaf = path[0], path[-1]
    if top in ("conv_in", "conv_out"):
        name, fn = _leaf("conv", leaf)
        return f"{top}.{name}", fn
    if top == "conv_norm_out":
        name, fn = _leaf("norm", leaf)
        return f"conv_norm_out.{name}", fn
    if top == "time_embedding":
        name, fn = _leaf("dense", leaf)
        return f"time_embedding.{path[1]}.{name}", fn

    m = re.fullmatch(r"(down|up)_(\d+)_resnet_(\d+)", top)
    mid = re.fullmatch(r"mid_resnet_(\d+)", top)
    if m or mid:
        base = (f"{m.group(1)}_blocks.{m.group(2)}.resnets.{m.group(3)}"
                if m else f"mid_block.resnets.{mid.group(1)}")
        sub = path[1]
        kind = ("norm" if sub.startswith("norm") else
                "dense" if sub == "time_emb_proj" else "conv")
        name, fn = _leaf(kind, leaf)
        return f"{base}.{sub}.{name}", fn

    m = re.fullmatch(r"(down|up)_(\d+)_attn_(\d+)", top)
    if m or top == "mid_attn":
        base = ("mid_block.attentions.0" if top == "mid_attn" else
                f"{m.group(1)}_blocks.{m.group(2)}.attentions.{m.group(3)}")
        sub = path[1]
        if sub == "norm":
            name, fn = _leaf("norm", leaf)
            return f"{base}.norm.{name}", fn
        if sub in ("proj_in", "proj_out"):
            name, fn = _leaf("dense", leaf)
            return f"{base}.{sub}.{name}", fn
        mb = re.fullmatch(r"blocks_(\d+)", sub)
        if mb:
            bb = f"{base}.transformer_blocks.{mb.group(1)}"
            s2 = path[2]
            if s2.startswith("norm"):
                name, fn = _leaf("norm", leaf)
                return f"{bb}.{s2}.{name}", fn
            if s2 in ("attn1", "attn2"):
                proj = "to_out.0" if path[3] == "to_out" else path[3]
                name, fn = _leaf("dense", leaf)
                return f"{bb}.{s2}.{proj}.{'base.' if path[4] == 'base' else ''}{name}", fn
            if s2 == "ff":
                if path[3] == "proj_in":
                    name, fn = _leaf("geglu", leaf)
                    return f"{bb}.ff.net.0.proj.{name}", fn
                name, fn = _leaf("dense", leaf)
                return f"{bb}.ff.net.2.{name}", fn

    m = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", top)
    if m:
        name, fn = _leaf("conv", leaf)
        return f"{m.group(1)}_blocks.{m.group(2)}.{m.group(3)}rs.0.conv.{name}", fn
    return None


def _clip_rule(path: Tuple[str, ...]) -> Optional[Rule]:
    pre = "text_model."
    top, leaf = path[0], path[-1]
    if top == "token_embedding":
        return pre + "embeddings.token_embedding.weight", _same
    if top == "position_embedding":
        return pre + "embeddings.position_embedding.weight", _same
    if top == "final_norm":
        name, fn = _leaf("norm", leaf)
        return pre + f"final_layer_norm.{name}", fn
    m = re.fullmatch(r"layers_(\d+)", top)
    if m:
        base = pre + f"encoder.layers.{m.group(1)}"
        sub = path[1]
        if sub in ("norm1", "norm2"):
            name, fn = _leaf("norm", leaf)
            return f"{base}.layer_{sub}.{name}", fn
        if sub in ("q_proj", "k_proj", "v_proj", "out_proj") and path[2] == "base":
            name, fn = _leaf("dense", leaf)
            return f"{base}.self_attn.{sub}.{name}", fn
        if sub in ("fc1", "fc2"):
            name, fn = _leaf("dense", leaf)
            return f"{base}.mlp.{sub}.{name}", fn
    return None


def _vae_rule(path: Tuple[str, ...]) -> Optional[Rule]:
    top, p1, leaf = path[0], path[1], path[-1]
    if top not in ("encoder", "decoder"):
        return None
    pre = f"{top}."
    if p1 in ("post_quant_conv", "quant_conv"):
        name, fn = _leaf("conv", leaf)
        return f"{p1}.{name}", fn
    if p1 in ("conv_in", "conv_out"):
        name, fn = _leaf("conv", leaf)
        return f"{pre}{p1}.{name}", fn
    if p1 == "conv_norm_out":
        name, fn = _leaf("norm", leaf)
        return f"{pre}conv_norm_out.{name}", fn
    m = re.fullmatch(r"mid_resnet_(\d+)", p1)
    m2 = re.fullmatch(r"(up|down)_(\d+)_resnet_(\d+)", p1)
    if m or m2:
        base = (f"{pre}mid_block.resnets.{m.group(1)}" if m else
                f"{pre}{m2.group(1)}_blocks.{m2.group(2)}.resnets.{m2.group(3)}")
        sub = path[2]
        name, fn = _leaf("norm" if sub.startswith("norm") else "conv", leaf)
        return f"{base}.{sub}.{name}", fn
    m = re.fullmatch(r"(up|down)_(\d+)_(upsample|downsample)", p1)
    if m:
        name, fn = _leaf("conv", leaf)
        return f"{pre}{m.group(1)}_blocks.{m.group(2)}.{m.group(3)}rs.0.conv.{name}", fn
    if p1 == "mid_attn":
        base = f"{pre}mid_block.attentions.0"
        sub = path[2]
        if sub == "norm":
            name, fn = _leaf("norm", leaf)
            return f"{base}.group_norm.{name}", fn
        name, fn = _leaf("dense", leaf)
        return f"{base}.{'to_out.0' if sub == 'to_out' else sub}.{name}", fn
    return None


_BLIP_TEXT = {
    "self_q": "attention.self.query", "self_k": "attention.self.key",
    "self_v": "attention.self.value", "self_out": "attention.output.dense",
    "self_norm": "attention.output.LayerNorm",
    "cross_q": "crossattention.self.query", "cross_k": "crossattention.self.key",
    "cross_v": "crossattention.self.value",
    "cross_out": "crossattention.output.dense",
    "cross_norm": "crossattention.output.LayerNorm",
    "fc1": "intermediate.dense", "fc2": "output.dense",
    "ff_norm": "output.LayerNorm",
}


def _blip_rule(path: Tuple[str, ...]) -> Optional[Rule]:
    """BLIPCaptioner leaves. The vision q, k and v map to thirds of the
    fused `qkv`, named `<qkv leaf>#<0|1|2>` and joined in `_convert`."""
    top, leaf = path[0], path[-1]
    norm = leaf == "scale" or (leaf == "bias" and path[-2].endswith("norm"))
    kind = "norm" if norm else "dense"
    if top == "vision":
        vpre = "vision_model."
        p1 = path[1]
        if p1 == "patch_embed":
            name, fn = _leaf("conv", leaf)
            return f"{vpre}embeddings.patch_embedding.{name}", fn
        if p1 == "cls_token":
            return f"{vpre}embeddings.class_embedding", _same
        if p1 == "pos_embed":
            return f"{vpre}embeddings.position_embedding", _same
        if p1 == "post_norm":
            return f"{vpre}post_layernorm.{_leaf('norm', leaf)[0]}", _same
        m = re.fullmatch(r"layers_(\d+)", p1)
        if m:
            base = f"{vpre}encoder.layers.{m.group(1)}"
            sub = path[2]
            if sub in ("norm1", "norm2"):
                return f"{base}.layer_{sub}.{_leaf('norm', leaf)[0]}", _same
            name, fn = _leaf("dense", leaf)
            if sub in ("q", "k", "v"):
                return f"{base}.self_attn.qkv.{name}#{'qkv'.index(sub)}", fn
            if sub == "proj":
                return f"{base}.self_attn.projection.{name}", fn
            return f"{base}.mlp.{sub}.{name}", fn
        return None
    tpre = "text_decoder.bert."
    if top == "word_embed":
        return f"{tpre}embeddings.word_embeddings.weight", _same
    if top == "text_pos_embed":
        return f"{tpre}embeddings.position_embeddings.weight", _same
    if top == "embed_norm":
        return f"{tpre}embeddings.LayerNorm.{_leaf('norm', leaf)[0]}", _same
    m = re.fullmatch(r"text_layers_(\d+)", top)
    if m and path[1] in _BLIP_TEXT:
        name, fn = _leaf(kind, leaf)
        return f"{tpre}encoder.layer.{m.group(1)}.{_BLIP_TEXT[path[1]]}.{name}", fn
    head = "text_decoder.cls.predictions."
    if top in ("head_transform", "head_norm"):
        name, fn = _leaf(kind, leaf)
        sub = "dense" if top == "head_transform" else "LayerNorm"
        return f"{head}transform.{sub}.{name}", fn
    if top == "lm_head":
        return (f"{head}decoder.weight", _dense) if leaf == "kernel" else (
            f"{head}bias", _same)
    return None


def blip_from_hf(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A transformers `BlipForConditionalGeneration` state dict (or the
    tensors of its safetensors snapshot) -> the port captioner's state
    dict. The names are the same; HF ties the LM head's decoder weight to
    the word embeddings and its decoder bias to `predictions.bias`, and a
    safetensors snapshot drops the tied weight, so it is restored from the
    embeddings (the port's copy of `hf_import._alias_tied_blip`). Tensors
    the captioner does not hold (the tied bias, `position_ids` buffers)
    are dropped."""
    head = "text_decoder.cls.predictions."
    out = {k: v for k, v in tensors.items()
           if not k.endswith("position_ids") and k != head + "decoder.bias"}
    if head + "decoder.weight" not in out:
        out[head + "decoder.weight"] = out[
            "text_decoder.bert.embeddings.word_embeddings.weight"]
    return out


def _swap_mid_blocks(x: np.ndarray, axis: int) -> np.ndarray:
    """Swap the 2nd and 3rd quarters of `axis`: Swin patch merging's
    sub-pixel order, flax's (x00, x01, x10, x11) against torch's (x00,
    x10, x01, x11), either way (comat_tpu/segmentation/gdino_import.py
    `_merge_perm`, `_merge_norm_perm`)."""
    q = np.split(np.asarray(x), 4, axis=axis)
    return np.concatenate([q[0], q[2], q[1], q[3]], axis=axis)


def _gd_dense(base: str, leaf: str) -> Tuple[str, Callable]:
    name, fn = _leaf("dense", leaf)
    return f"{base}.{name}", fn


def _gd_norm(base: str, leaf: str) -> Tuple[str, Callable]:
    name, fn = _leaf("norm", leaf)
    return f"{base}.{name}", fn


def _gd_packed(base: str, sub: str, leaf: str) -> Tuple[str, Callable]:
    """q, k, v Dense -> a third of torch MultiheadAttention's packed
    in_proj (joined in `_convert`); "out" -> out_proj."""
    if sub in ("q", "k", "v"):
        kind = "weight" if leaf == "kernel" else "bias"
        return f"{base}.in_proj_{kind}#{'qkv'.index(sub)}", (_dense if leaf == "kernel"
                                                              else _same)
    return _gd_dense(f"{base}.out_proj", leaf)


def _gd_swin(p: Tuple[str, ...], leaf: str) -> Optional[Rule]:
    base = "backbone.0"
    top = p[0]
    if top == "patch_embed":
        name, fn = _leaf("conv", leaf)
        return f"{base}.patch_embed.proj.{name}", fn
    if top == "patch_norm":
        return _gd_norm(f"{base}.patch_embed.norm", leaf)
    m = re.fullmatch(r"stage(\d+)_block(\d+)", top)
    if m:
        blk = f"{base}.layers.{m.group(1)}.blocks.{m.group(2)}"
        if p[1] == "attn":
            if p[2] == "rel_pos_bias":
                return f"{blk}.attn.relative_position_bias_table", _same
            return _gd_dense(f"{blk}.attn.{p[2]}", leaf)
        if p[1] in ("norm1", "norm2"):
            return _gd_norm(f"{blk}.{p[1]}", leaf)
        return _gd_dense(f"{blk}.mlp.{p[1]}", leaf)
    m = re.fullmatch(r"merge_norm(\d+)", top)
    if m:
        name, _ = _leaf("norm", leaf)
        return (f"{base}.layers.{m.group(1)}.downsample.norm.{name}",
                lambda x: _swap_mid_blocks(x, 0))
    m = re.fullmatch(r"merge(\d+)", top)
    if m:
        return (f"{base}.layers.{m.group(1)}.downsample.reduction.weight",
                lambda x: _swap_mid_blocks(_dense(x), 1))
    m = re.fullmatch(r"out_norm(\d+)", top)
    if m:
        return _gd_norm(f"{base}.norm{m.group(1)}", leaf)
    return None


_GD_BERT = {"query": "attention.self.query", "key": "attention.self.key",
            "value": "attention.self.value", "attn_out": "attention.output.dense",
            "attn_norm": "attention.output.LayerNorm",
            "intermediate": "intermediate.dense", "output": "output.dense",
            "out_norm": "output.LayerNorm"}
_GD_DEFORM = {"offsets": "sampling_offsets", "weights": "attention_weights",
              "value": "value_proj", "out": "output_proj", "da_out": "output_proj"}
_GD_DEC_NORM = {"norm_sa": "norm2", "norm_ca": "catext_norm", "norm_da": "norm1",
                "norm_ffn": "norm3"}


def _gdino_rule(path: Tuple[str, ...]) -> Optional[Rule]:
    """GroundingDetector leaves -> the IDEA release's names, which the
    port's module carries (the inverse of comat_tpu/segmentation/
    gdino_import.py `gdino_hf_name`); the tiny configs' conv backbone
    under backbone.0.bb / bbn."""
    top, leaf = path[0], path[-1]
    if top == "swin":
        return _gd_swin(path[1:], leaf)
    m = re.fullmatch(r"(bb|bbn)(\d)", top)
    if m:
        name, fn = _leaf("conv" if m.group(1) == "bb" else "norm", leaf)
        return f"backbone.0.{m.group(1)}.{m.group(2)}.{name}", fn
    if top == "bert":
        sub = path[1]
        if sub in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
            return f"bert.embeddings.{sub}.weight", _same
        if sub == "emb_norm":
            return _gd_norm("bert.embeddings.LayerNorm", leaf)
        m = re.fullmatch(r"layer(\d+)", sub)
        name, fn = _leaf("norm" if path[2].endswith("norm") else "dense", leaf)
        return f"bert.encoder.layer.{m.group(1)}.{_GD_BERT[path[2]]}.{name}", fn
    if top == "feat_map":
        return _gd_dense("feat_map", leaf)
    m = re.fullmatch(r"input_proj(\d+)_(conv|norm)", top)
    if m:
        name, fn = _leaf(m.group(2), leaf)
        return f"input_proj.{m.group(1)}.{0 if m.group(2) == 'conv' else 1}.{name}", fn
    if top == "level_embed":
        return "transformer.level_embed", _same
    if top == "tgt_embed":
        return "transformer.tgt_embed.weight", _same
    m = re.fullmatch(r"fuse(\d+)", top)
    if m:
        fb = f"transformer.encoder.fusion_layers.{m.group(1)}"
        sub = path[1]
        if sub in ("gamma_v", "gamma_l"):
            return f"{fb}.{sub}", _same
        if sub in ("layer_norm_v", "layer_norm_l"):
            return _gd_norm(f"{fb}.{sub}", leaf)
        return _gd_dense(f"{fb}.attn.{sub}", leaf)
    m = re.fullmatch(r"(text_enc|enc|dec)(\d+)", top)
    if m:
        kind, i, sub = m.group(1), m.group(2), path[1]
        base = {"text_enc": "transformer.encoder.text_layers",
                "enc": "transformer.encoder.layers",
                "dec": "transformer.decoder.layers"}[kind] + f".{i}"
        if sub in ("fc1", "fc2"):
            return _gd_dense(f"{base}.linear{sub[-1]}", leaf)
        if kind == "text_enc":
            if sub in ("norm1", "norm2"):
                return _gd_norm(f"{base}.{sub}", leaf)
            return _gd_packed(f"{base}.self_attn", sub, leaf)
        attn = "self_attn" if kind == "enc" else "cross_attn"
        if sub in _GD_DEFORM:
            return _gd_dense(f"{base}.{attn}.{_GD_DEFORM[sub]}", leaf)
        if kind == "enc":
            return _gd_norm(f"{base}.{sub}", leaf)
        if sub in _GD_DEC_NORM:
            return _gd_norm(f"{base}.{_GD_DEC_NORM[sub]}", leaf)
        mha = "self_attn" if sub.startswith("sa_") else "ca_text"
        return _gd_packed(f"{base}.{mha}", sub[3:], leaf)
    mlp = {"enc_out_bbox_embed": "transformer.enc_out_bbox_embed",
           "ref_point_head": "transformer.decoder.ref_point_head"}
    m = re.fullmatch(r"bbox_embed(\d+)", top)
    if top in mlp or m:
        base = mlp[top] if top in mlp else f"transformer.decoder.bbox_embed.{m.group(1)}"
        return _gd_dense(f"{base}.layers.{path[1][1:]}", leaf)
    if top in ("enc_output", "enc_output_norm", "dec_norm"):
        base = "transformer.decoder.norm" if top == "dec_norm" else f"transformer.{top}"
        return (_gd_norm if top.endswith("norm") else _gd_dense)(base, leaf)
    return None


# the port YoloV8Seg's layer index of each JAX module (the yolov8-seg yaml's,
# comat_tpu/segmentation/weights_import.py `_LAYER_IDX`); 22 is the head
_FS_LAYER = {"stem": 0, "down1": 1, "c2f1": 2, "down2": 3, "c2f2": 4, "down3": 5,
             "c2f3": 6, "down4": 7, "c2f4": 8, "sppf": 9, "up_c2f4": 12, "up_c2f3": 15,
             "dn_conv3": 16, "dn_c2f4": 18, "dn_conv4": 19, "dn_c2f5": 21}


def _convT(x):
    """flax ConvTranspose kernel (kh, kw, I, O), taps flipped against
    torch's -> torch ConvTranspose2d (I, O, kh, kw) (the inverse of
    weights_import.py `_convT`)."""
    return np.ascontiguousarray(np.transpose(np.asarray(x)[::-1, ::-1], (2, 3, 0, 1)))


def _fs_convbn(base: str, sub: Tuple[str, ...]) -> Optional[Rule]:
    if sub[0] == "conv":
        return f"{base}.conv.weight", _conv
    stat = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
    return f"{base}.bn.{stat[sub[-1]]}", _same


def _fastsam_rule(path: Tuple[str, ...]) -> Optional[Rule]:
    """YoloV8Seg leaves (params and batch_stats) -> ultralytics' names as
    the port's module carries them ("model.{idx}...")."""
    top = path[0]
    if top in _FS_LAYER:
        base = f"model.{_FS_LAYER[top]}"
        if top == "sppf" or top.startswith(("c2f", "up_c2f", "dn_c2f")):
            m = re.fullmatch(r"m(\d+)", path[1])
            if m:
                return _fs_convbn(f"{base}.m.{m.group(1)}.{path[2]}", path[3:])
            return _fs_convbn(f"{base}.{path[1]}", path[2:])
        return _fs_convbn(base, path[1:])
    m = re.fullmatch(r"(box|cls|mc)(\d)_(cv1|cv2|out)", top)
    if m:
        branch = {"box": "cv2", "cls": "cv3", "mc": "cv4"}[m.group(1)]
        stage = {"cv1": 0, "cv2": 1, "out": 2}[m.group(3)]
        base = f"model.22.{branch}.{m.group(2)}.{stage}"
        if m.group(3) == "out":
            return (f"{base}.weight", _conv) if path[-1] == "kernel" else (
                f"{base}.bias", _same)
        return _fs_convbn(base, path[1:])
    m = re.fullmatch(r"proto_(cv1|cv2|cv3|up)", top)
    if m and m.group(1) == "up":
        return (("model.22.proto.upsample.weight", _convT) if path[-1] == "kernel"
                else ("model.22.proto.upsample.bias", _same))
    if m:
        return _fs_convbn(f"model.22.proto.{m.group(1)}", path[1:])
    return None


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _convert(tree: Mapping, rule) -> Dict[str, torch.Tensor]:
    tree = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        mapped = rule(path)
        if mapped is None:
            continue
        name, fn = mapped
        out[name] = torch.tensor(np.asarray(fn(leaf)))
    for name in sorted(n for n in out if n.endswith("#0")):
        parts = [out.pop(f"{name[:-2]}#{i}") for i in range(3)]
        out[name[:-2]] = torch.cat(parts, dim=0)
    return out


def _disc_convert(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX discriminator tree {"unet": ..., "head": {"params": {"mlp":
    {kernel (4, 1), bias (1,)}}}} -> the port `Discriminator`'s state
    dict ("unet.<name>", "head.mlp.weight" (1, 4), "head.mlp.bias")."""
    out = {f"unet.{k}": v for k, v in _convert(tree["unet"], _unet_rule).items()}
    if "head" in tree:
        mlp = tree["head"].get("params", tree["head"])["mlp"]
        out["head.mlp.weight"] = torch.tensor(_dense(mlp["kernel"]))
        out["head.mlp.bias"] = torch.tensor(np.asarray(mlp["bias"]))
    return out


def from_jax_params(tree: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"unet", "text", "vae", "blip", "disc", "gdino", "fastsam"} JAX
    parameter trees, as numpy arrays -> state dicts of the port's modules
    under the same keys (CPU fp32 tensors; the modules cast them to their
    own dtypes on load). "disc" is a discriminator's tree
    (`losses.gan.Discriminator`); "vae" the whole AutoencoderKL, encoder
    and decoder; "gdino" a GroundingDetector's and "fastsam" a YoloV8Seg's
    variables ({"params", "batch_stats"}), whose state dicts carry the
    IDEA and ultralytics checkpoints' names: the JAX importers' transforms
    are inverted (dense and conv transposes, q/k/v joined into packed
    in_proj thirds, the patch-merge block order, the ConvTranspose tap
    flip). Keys missing from `tree` are missing from the result."""
    rules = {"unet": _unet_rule, "text": _clip_rule, "vae": _vae_rule,
             "blip": _blip_rule, "gdino": _gdino_rule}
    out = {k: _convert(tree[k], rule) for k, rule in rules.items() if k in tree}
    if "fastsam" in tree:
        fs = tree["fastsam"]
        out["fastsam"] = _convert(fs["params"], _fastsam_rule)
        out["fastsam"].update(_convert(fs.get("batch_stats", {}), _fastsam_rule))
    if "disc" in tree:
        out["disc"] = _disc_convert(tree["disc"])
    return out


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator,
                  skip: Iterable[str] = ()) -> None:
    """Seeded random weights, in place: every parameter with two or more
    dims ~ N(0, 1/fan_in) (fan_in = the product of all dims but the
    first; `lora_a` ~ N(0, 1/rank^2) and `lora_b` = 0 as in JAX), norm
    scales 1 and biases 0. Parameters are drawn in name order from
    `generator`, in fp32 on the generator's device; those named in `skip`
    are left as they are."""
    skip = set(skip)
    for name, p in sorted(module.named_parameters()):
        if name in skip:
            continue
        if name.endswith("lora_b"):
            p.zero_()
        elif name.endswith("lora_a"):
            draw = torch.randn(p.shape, generator=generator,
                               device=generator.device)
            p.copy_(draw / p.shape[1])
        elif p.dim() >= 2:
            fan_in = p[0].numel()
            draw = torch.randn(p.shape, generator=generator,
                               device=generator.device)
            p.copy_(draw * fan_in ** -0.5)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
