"""Diffusers and transformers snapshots into the port's modules.

The port's counterpart of comat_tpu/models/hf_import.py (`load_sd_params`,
`load_unet_params`, `load_blip_params`, `load_blip_vqa_params`,
`load_lora_safetensors` (and `load_lora_state`, which also reads the
text towers' LoRA), `alias_diffusers_lora_keys`,
`_load_safetensors_dir`, `_alias_tied_blip`), read from it and not
imported. The port's modules carry diffusers' and transformers'
state-dict names, so a snapshot's tensors need only a few renames and
reshapes (`unet_from_diffusers`, `vae_from_diffusers`, `clip_from_hf`,
`blip_from_hf`, `blip_vqa_from_hf`; a text tower that carries LoRA keeps
its projections under `.base`, `clip_lora_names`); `load_into` then copies them into a
module in place, tensor by tensor, from the file's memory map to the
parameter's device and dtype. It never replaces a `Parameter` object, so
what shares a tower's tensors (a discriminator's base, `share_base_unet`)
keeps sharing them. A tensor that lands in a narrower dtype (an fp32 or
fp16 file into a bf16 tower) is widened to fp32 (exactly) and rounded
once, to nearest even, as JAX's `astype` rounds its fp32 leaf at use.

A snapshot is a diffusers pipeline folder (unet/, vae/, text_encoder/ and,
for SDXL, text_encoder_2/) or a transformers model folder (BLIP), each
with safetensors files; `.bin`-only folders are not read, as in JAX.
Snapshots saved by older diffusers name the VAE's mid-block attention
`query`, `key`, `value` and `proj_attn`; diffusers renames them at load
and so does the port (JAX's mapper knows only the new names).
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from comat_tpu_torch.models.lora import is_lora_path
from comat_tpu_torch.training.checkpoints import load_safetensors

# the pipeline's towers and their snapshot folders
SNAPSHOT_TOWERS = (("unet", "unet"), ("vae", "vae"), ("text", "text_encoder"),
                   ("text2", "text_encoder_2"))
CAPTION_MODEL_ID = "Salesforce/blip-image-captioning-large"


def resolve_snapshot(path: Optional[str], cache_dir: Optional[str]) -> Optional[str]:
    """A HF repo id resolved against --cache_dir's hub layout
    (cache_dir/models--org--name/snapshots/<rev>, the revision refs/main
    names, else the newest) or a plain cache_dir/name directory; a local
    path as it is (JAX's `Trainer._resolve_snapshot`)."""
    if not path or os.path.isdir(path) or not cache_dir:
        return path
    for c in (os.path.join(cache_dir, "models--" + path.replace("/", "--"), "snapshots"),
              os.path.join(cache_dir, path.split("/")[-1]),
              os.path.join(cache_dir, path)):
        if not os.path.isdir(c):
            continue
        if not c.endswith("snapshots"):
            return c
        ref = os.path.join(os.path.dirname(c), "refs", "main")
        if os.path.isfile(ref):
            with open(ref) as f:
                rev = os.path.join(c, f.read().strip())
            if os.path.isdir(rev):
                return rev
        revs = [os.path.join(c, r) for r in os.listdir(c)
                if os.path.isdir(os.path.join(c, r))]
        if revs:
            return max(revs, key=os.path.getmtime)
    return path


_SHARD = re.compile(r"-(\d{5})-of-(\d{5})$")


def safetensors_files(d: str) -> List[str]:
    """The safetensors files of one component folder that the port reads:
    the non-variant set (`diffusion_pytorch_model.safetensors`,
    `model.safetensors`, or its `-0000k-of-0000n` shards), else the one
    variant set present (e.g. `*.fp16.safetensors`). Several variants and
    no non-variant set raise, naming them; so does a missing shard. JAX
    reads every file of the folder in sorted order, so that a non-variant
    file overwrites a variant's tensors: the port's choice gives the same
    values, reading one set."""
    names = sorted(f for f in os.listdir(d) if f.endswith(".safetensors")) \
        if os.path.isdir(d) else []
    if not names:
        raise FileNotFoundError(f"no .safetensors file in {d}")
    sets: Dict[Optional[str], List[str]] = {}
    totals: Dict[Optional[str], set] = {}
    for f in names:
        stem = f[:-len(".safetensors")]
        m = _SHARD.search(stem)
        if m:
            stem = stem[:m.start()]
        variant = stem.partition(".")[2] or None
        sets.setdefault(variant, []).append(f)
        if m:
            totals.setdefault(variant, set()).add(int(m.group(2)))
    if None in sets:
        variant = None
    elif len(sets) == 1:
        variant = next(iter(sets))
    else:
        raise ValueError(f"{d}: several variant file sets {sorted(sets)} and no "
                         "non-variant one; keep one")
    files = sets[variant]
    for total in totals.get(variant, ()):
        if sum(_SHARD.search(f[:-len(".safetensors")]) is not None for f in files) != total:
            raise FileNotFoundError(f"{d}: {len(files)} files of a {total}-shard set")
    return [os.path.join(d, f) for f in files]


def load_safetensors_dir(d: str) -> Dict[str, np.ndarray]:
    """The tensors of one component folder's file set (`safetensors_files`),
    memory-mapped (`training.checkpoints.load_safetensors`)."""
    out: Dict[str, np.ndarray] = {}
    for path in safetensors_files(d):
        out.update(load_safetensors(path))
    return out


# ---- names ----

_ATTN_PROJ = re.compile(r"(.+\.attn[12]\.(?:to_q|to_k|to_v|to_out\.0))\.(weight|bias)")


def unet_from_diffusers(tensors: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A diffusers UNet2DConditionModel's tensors under the port UNet's
    names: an attention projection's weight and bias move under `.base`
    (models/lora.py), and a transformer's proj_in / proj_out stored as a
    1x1 conv (SD1.5; SDXL's are linear) loses its two unit dims (the
    port's copy of `hf_import._unet_hf_name`'s `proj_f`). Every other name
    is the port's own. The values are views of the inputs."""
    out = {}
    for name, value in tensors.items():
        m = _ATTN_PROJ.fullmatch(name)
        if m:
            name = f"{m.group(1)}.base.{m.group(2)}"
        elif re.search(r"\.attentions\.\d+\.proj_(in|out)\.weight$", name) and value.ndim == 4:
            value = value[:, :, 0, 0]
        out[name] = value
    return out


_VAE_OLD_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}
_VAE_ATTN = re.compile(r"(.+\.mid_block\.attentions\.0)\.(query|key|value|proj_attn|to_q|to_k"
                       r"|to_v|to_out\.0)\.(weight|bias)")


def vae_from_diffusers(tensors: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A diffusers AutoencoderKL's tensors under the port VAE's names (the
    same), with the mid-block attention of older snapshots renamed as
    diffusers' `_convert_deprecated_attention_blocks` renames it (`query`,
    `key`, `value`, `proj_attn` -> `to_q`, `to_k`, `to_v`, `to_out.0`)
    and a projection weight stored as a 1x1 conv squeezed to 2-D."""
    out = {}
    for name, value in tensors.items():
        m = _VAE_ATTN.fullmatch(name)
        if m:
            name = f"{m.group(1)}.{_VAE_OLD_ATTN.get(m.group(2), m.group(2))}.{m.group(3)}"
            if value.ndim == 4:
                value = value[:, :, 0, 0]
        out[name] = value
    return out


_CLIP_PROJ = re.compile(r"(.+\.self_attn\.(?:q|k|v|out)_proj)\.(weight|bias)")


def clip_lora_names(tensors: Mapping[str, object]) -> Dict[str, object]:
    """CLIP tensors under the names of a tower that carries LoRA
    (`CLIPTextEncoder(lora_rank > 0)`): each attention projection's
    weight and bias move under `.base`, as `unet_from_diffusers` moves the
    UNet's."""
    out = {}
    for name, value in tensors.items():
        m = _CLIP_PROJ.fullmatch(name)
        out[f"{m.group(1)}.base.{m.group(2)}" if m else name] = value
    return out


def clip_from_hf(tensors: Mapping[str, np.ndarray], lora: bool = False) -> Dict[str, np.ndarray]:
    """A transformers CLIPTextModel's (or CLIPTextModelWithProjection's)
    tensors under the port CLIP's names: the same (`text_model.*`, and
    bigG's `text_projection.weight` (proj, hidden), as the port's
    nn.Linear holds it), without the `position_ids` buffers; `lora`: for
    a tower that carries LoRA (`clip_lora_names`)."""
    out = {k: v for k, v in tensors.items() if not k.endswith("position_ids")}
    return clip_lora_names(out) if lora else out


def blip_from_hf(tensors: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A transformers `BlipForConditionalGeneration` state dict (or the
    tensors of its safetensors snapshot) -> the port captioner's state
    dict; a `BlipForQuestionAnswering`'s -> the port `BLIPVQA`'s. The names are the same; HF ties the LM head's decoder weight to
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


# transformers' `BlipForQuestionAnswering` names are the port `BLIPVQA`'s
# too (JAX's `_blip_vqa_hf_name` :403 maps its own), and its answer
# decoder ties its LM head as the captioner's does
blip_vqa_from_hf = blip_from_hf


def _tower_names(tower: str, module: nn.Module):
    """The rename of `tower`'s snapshot tensors into `module`'s names."""
    if tower in ("text", "text2"):
        return lambda t: clip_from_hf(t, lora=getattr(module, "lora_rank", 0) > 0)
    return {"unet": unet_from_diffusers, "vae": vae_from_diffusers}[tower]


# a LoRA factor in the reference's LoraLoaderMixin layout (what
# `checkpoints.export_lora_safetensors` writes) and in the attn-processor
# layout (`hf_import.alias_diffusers_lora_keys` :562)
_LORA_MIXIN = re.compile(r"unet\.(.+\.attn[12]\.(?:to_q|to_k|to_v|to_out\.0))"
                         r"\.lora\.(down|up)\.weight")
_LORA_PROCESSOR = re.compile(r"(?:unet\.)?(.+\.attn[12])\.processor\.(to_q|to_k|to_v|to_out)"
                             r"_lora\.(down|up)\.weight")
# a text tower's factor: the reference's LoraLoaderMixin writes
# `.lora_linear_layer.{down,up}` (what the port exports), JAX's exporter
# `.lora.{down,up}` (comat_tpu/models/hf_import.py:617)
_LORA_TEXT = re.compile(r"(text_encoder(?:_2)?)\.(text_model\.encoder\.layers\.\d+\.self_attn"
                        r"\.(?:q|k|v|out)_proj)\.(?:lora_linear_layer|lora)\.(down|up)\.weight")
_TEXT_LORA_TOWERS = {"text_encoder": "text", "text_encoder_2": "text2"}


def lora_from_diffusers(tensors: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A pytorch_lora_weights.safetensors' LoRA factors under the port's
    names, down (rank, in) -> `lora_a` (in, rank) and up (out, rank) ->
    `lora_b` (rank, out): the UNet's under the UNet's names, the text
    towers' under "text.<name>" / "text2.<name>" (either spelling,
    `_LORA_TEXT`); other tensors keep their names."""
    out = {}
    for name, value in tensors.items():
        m = _LORA_MIXIN.fullmatch(name)
        t = _LORA_TEXT.fullmatch(name)
        if t:
            enc, module, dd = t.groups()
            module = f"{_TEXT_LORA_TOWERS[enc]}.{module}"
        elif m:
            module, dd = m.groups()
        else:
            m = _LORA_PROCESSOR.fullmatch(name)
            if m is None:
                out[name] = value
                continue
            block, proj, dd = m.groups()
            module = f"{block}.{'to_out.0' if proj == 'to_out' else proj}"
        out[f"{module}.lora_{'a' if dd == 'down' else 'b'}"] = value.T
    return out


# ---- copying ----

@dataclasses.dataclass
class LoadReport:
    """What one load did: the module's tensors the file lacks (LoRA factors
    aside, unless the file is a LoRA file), the file's tensors the module
    does not hold, the bytes read, the seconds spent reading the file into
    host memory and copying to the module's device, and, where asked, the
    fp32 values of the tensors that landed in a narrower dtype, by name."""

    missing: List[str] = dataclasses.field(default_factory=list)
    unused: List[str] = dataclasses.field(default_factory=list)
    nbytes: int = 0
    read_s: float = 0.0
    copy_s: float = 0.0
    masters: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


@torch.no_grad()
def load_into(module: nn.Module, tensors: Dict[str, np.ndarray], keep_masters: bool = False,
              prefix: str = "", lora: bool = False) -> LoadReport:
    """Copy `tensors` (numpy arrays, memory-mapped or not, or CPU tensors)
    into `module`'s parameters and persistent buffers of the same names,
    in place. Each tensor is dropped from `tensors` once copied, so that a
    memory-mapped file is let go page range by page range. A shape that
    differs raises. `keep_masters`: keep the fp32 values of the tensors
    copied into a narrower float dtype, under `prefix` + name. `lora`: the
    file is a LoRA file, so the module's LoRA factors are what it must
    cover (and its other tensors are not missing)."""
    own = module.state_dict(keep_vars=True)
    report = LoadReport(missing=[n for n in own if n not in tensors
                                 and is_lora_path(n) == lora])
    sync = None
    for name in list(tensors):
        src = tensors.pop(name)
        dst = own.get(name)
        if dst is None:
            report.unused.append(name)
            continue
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{prefix}{name}: shape {tuple(src.shape)} in the file, "
                             f"{tuple(dst.shape)} in the module")
        t0 = time.perf_counter()
        host = src if isinstance(src, torch.Tensor) else torch.from_numpy(np.array(src))
        t1 = time.perf_counter()
        value = host.to(dst.device)
        if value.is_floating_point() and value.dtype != dst.dtype:
            value = value.float()          # exact: fp16 and bf16 widen
        dst.copy_(value)                   # one rounding, to nearest even
        if keep_masters and dst.is_floating_point() and dst.dtype != torch.float32:
            report.masters[prefix + name] = value if value.dtype == torch.float32 \
                else value.float()
        if dst.device.type == "cuda":
            sync = dst.device
        report.nbytes += host.numel() * host.element_size()
        report.read_s += t1 - t0
        report.copy_s += time.perf_counter() - t1
    if sync is not None:
        t0 = time.perf_counter()
        torch.cuda.synchronize(sync)
        report.copy_s += time.perf_counter() - t0
    return report


def load_sd_state(snapshot_dir: str, pipeline, keep_masters: Sequence[str] = ()
                  ) -> Dict[str, LoadReport]:
    """A diffusers SD1.5 or SDXL snapshot into `pipeline`'s towers in place
    (the counterpart of `hf_import.load_sd_params` :636): unet/, vae/,
    text_encoder/ and, where the pipeline has a second tower,
    text_encoder_2/. Returns each tower's `LoadReport` by tower name; a
    tower whose folder the snapshot lacks reports all its tensors missing
    (JAX keeps it as it was, unreported). `keep_masters`: the towers (e.g.
    ("vae",)) whose fp32 values to keep, as the masters of a trained bf16
    tower (`init_train_state(initial_masters=)`), under "<tower>.<name>"."""
    reports = {}
    for tower, sub in SNAPSHOT_TOWERS:
        module = getattr(pipeline, tower, None)
        if module is None:
            continue
        d = os.path.join(snapshot_dir, sub)
        if not os.path.isdir(d):
            reports[tower] = LoadReport(missing=[n for n in module.state_dict()
                                                 if not is_lora_path(n)])
            continue
        reports[tower] = load_into(module, _tower_names(tower, module)(load_safetensors_dir(d)),
                                   keep_masters=tower in keep_masters, prefix=f"{tower}.")
    return reports


def load_unet_state(path: str, unet: nn.Module, keep_masters: bool = False) -> LoadReport:
    """A diffusers UNet, a .safetensors file or a folder of them (its
    `unet/` folder), into `unet` in place (the counterpart of
    `hf_import.load_unet_params` :528; --sdxl_unet_path). `keep_masters`:
    the fp32 values under "unet.<name>" (--full_finetuning)."""
    tensors = load_safetensors_dir(path) if os.path.isdir(path) else load_safetensors(path)
    return load_into(unet, unet_from_diffusers(tensors), keep_masters=keep_masters,
                     prefix="unet.")


def load_blip_state(snapshot_dir: str, blip: nn.Module) -> LoadReport:
    """A transformers BlipForConditionalGeneration snapshot into the port's
    captioner in place, the tied LM head restored (the counterpart of
    `hf_import.load_blip_params` :453)."""
    return load_into(blip, blip_from_hf(load_safetensors_dir(snapshot_dir)))


def load_blip_vqa_state(snapshot_dir: str, vqa: nn.Module) -> LoadReport:
    """A transformers BlipForQuestionAnswering snapshot (e.g.
    Salesforce/blip-vqa-base) into the port's `BLIPVQA` in place, the
    tied LM head restored (the counterpart of
    `hf_import.load_blip_vqa_params` :438)."""
    return load_into(vqa, blip_vqa_from_hf(load_safetensors_dir(snapshot_dir)))


def load_lora_safetensors(path: str, unet: nn.Module) -> LoadReport:
    """A pytorch_lora_weights.safetensors, in the reference's layout
    (`unet.<module>.lora.{down,up}.weight`, as the port's trainer exports
    it) or the attn-processor layout, into `unet`'s LoRA factors in place
    (the counterpart of `hf_import.load_lora_safetensors` :621). `missing`
    lists the UNet's factors the file lacks; `unused` the file's other
    tensors."""
    return load_into(unet, lora_from_diffusers(load_safetensors(path)), lora=True)


def load_lora_state(path: str, pipeline) -> Dict[str, LoadReport]:
    """A pytorch_lora_weights.safetensors as the port's trainer exports it
    into `pipeline` in place, each tower's `LoadReport` by name: the UNet's
    LoRA factors ("unet", `missing` lists those the file lacks), the text
    towers' LoRA factors in either spelling, and the tensors of towers
    trained whole (--tune_vae, --tune_text_encoder, --full_finetuning),
    which the trainer writes under the port's names ("vae.<name>",
    "text.<name>", "unet.<name>"). A text tower with LoRA factors in the
    file reports those the file lacks, one without the tensors it lacks;
    the file's tensors no tower holds are the UNet report's `unused`. JAX's loader reads the UNet's factors alone
    (comat_tpu/models/hf_import.py:621); the port loads the text LoRA as
    the reference's LoraLoaderMixin does."""
    tensors = lora_from_diffusers(load_safetensors(path))
    reports = {}
    for tower in ("text", "text2", "vae"):
        module = getattr(pipeline, tower, None)
        pre = tower + "."
        own = {n[len(pre):]: tensors.pop(n) for n in list(tensors) if n.startswith(pre)}
        if module is None or not own:
            tensors.update({pre + n: v for n, v in own.items()})
            continue
        reports[tower] = load_into(module, own, lora=any(is_lora_path(n) for n in own),
                                   prefix=pre)
    whole = {n[len("unet."):]: tensors.pop(n) for n in list(tensors)
             if n.startswith("unet.")}
    reports["unet"] = load_into(pipeline.unet, {**tensors, **whole}, lora=True)
    return reports


def lora_rank(path: str, tower: str = "unet") -> int:
    """The rank of a pytorch_lora_weights.safetensors' LoRA factors of
    `tower` ("unet", "text" or "text2"), from their shapes (0 when it
    holds none)."""
    for name, value in lora_from_diffusers(load_safetensors(path)).items():
        if not name.endswith(".lora_a"):
            continue
        owner = name.split(".", 1)[0]
        if owner == tower or (tower == "unet" and owner not in ("text", "text2")):
            return int(value.shape[1])
    return 0
