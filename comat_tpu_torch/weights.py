"""Weights for the port: carried across from a JAX parameter tree, or
made from a seed.

`from_jax_params` is the port's own copy of the name mapping of
comat_tpu/models/hf_import.py (`_unet_hf_name`, `_clip_hf_name`,
`_vae_hf_name`, `_blip_hf_name`), read from it and not imported. Layouts
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
    """{"unet", "text", "vae", "blip", "disc"} JAX parameter trees, as
    numpy arrays -> state dicts of the port's modules under the same keys
    (CPU fp32 tensors; the modules cast them to their own dtypes on load).
    "disc" is a discriminator's tree (`losses.gan.Discriminator`); "vae"
    the whole AutoencoderKL, encoder and decoder. Keys missing from
    `tree` are missing from the result."""
    rules = {"unet": _unet_rule, "text": _clip_rule, "vae": _vae_rule,
             "blip": _blip_rule}
    out = {k: _convert(tree[k], rule) for k, rule in rules.items() if k in tree}
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
