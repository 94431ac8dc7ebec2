"""Checkpoint save and resume, and the LoRA export.

The port's counterpart of comat_tpu/training/checkpoints.py. The
reference's layout (training_script.py:382-426, 156-205):
`<output_dir>/checkpoint-{step}/` directories, a `latest` resume that
sorts them by step, and `checkpoints_total_limit` pruning of the oldest.
A checkpoint holds, beside `metadata.json` ({"step": n}), one `state.pt`
(torch.save): the generator's and the discriminator's trainable tensors
that are their own fp32 masters, the optimizers' state (the fp32 masters
of bf16 tensors, from which restore writes their bf16 working copies;
AdamW's moments and steps, int8 with --use_8bit_adam; the update count
and, under gradient accumulation, the running mean of the gradients and
the micro-step counter), the `torch.Generator`
state the step draws come from (the counterpart of the JAX rng key) and
what the trainer adds (`extra`). Single process: no barriers.

`export_lora_safetensors` writes `pytorch_lora_weights.safetensors` with
the reference's keys and orientation (`unet.<module>.lora.{down,up}.weight`,
down (rank, in), up (out, rank)), the port's copy of JAX's
`export_lora_safetensors` and `hf_import.diffusers_lora_export_name`; the
text towers' factors (--train_text_encoder_lora) under the keys the
reference's LoraLoaderMixin writes,
`text_encoder[_2].text_model.encoder.layers.N.self_attn.<proj>.lora_linear_layer.{down,up}.weight`
(JAX writes `.lora.{down,up}` there, comat_tpu/models/hf_import.py:617;
the port writes what diffusers loads, and reads both).
The safetensors format is written and read by hand (`save_safetensors`,
`load_safetensors`): an 8-byte little-endian header length, a JSON header
of dtype, shape and `data_offsets`, then the raw little-endian bytes.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_LORA_RE = re.compile(r"unet\.(.+\.attn[12]\.(?:to_q|to_k|to_v|to_out\.0))\.lora_([ab])")
_TEXT_LORA_RE = re.compile(r"(text2?)\.(text_model\.encoder\.layers\.\d+\.self_attn"
                           r"\.(?:q|k|v|out)_proj)\.lora_([ab])")
_TEXT_ENCODERS = {"text": "text_encoder", "text2": "text_encoder_2"}


def _ckpt_dirs(output_dir: str):
    if not os.path.isdir(output_dir):
        return []
    out = []
    for d in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", d)
        if m:
            out.append((int(m.group(1)), os.path.join(output_dir, d)))
    return sorted(out)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The reference's 'latest' scan (training_script.py:163-167)."""
    dirs = _ckpt_dirs(output_dir)
    return dirs[-1][1] if dirs else None


def _trainable(state) -> Dict[str, torch.Tensor]:
    """The trainable tensors a checkpoint keeps itself: those that are
    their own fp32 masters. A bf16 working copy is its master rounded, and
    its master is in the optimizer's state."""
    masters = state.optimizer.masters
    return {n: p.detach() for n, p in state.trainable.items() if masters[n] is p}


def save_checkpoint(
    output_dir: str, step: int, state, d_state=None,
    generator: Optional[torch.Generator] = None,
    extra: Optional[Mapping[str, Any]] = None,
    total_limit: Optional[int] = None,
) -> str:
    """Write `checkpoint-{step}/` (state.pt, then metadata.json) and prune
    to the newest `total_limit`. `state` is a train_step.TrainState,
    `d_state` a DiscState. Returns the directory."""
    path = os.path.abspath(os.path.join(output_dir, f"checkpoint-{step}"))
    os.makedirs(path, exist_ok=True)
    payload: Dict[str, Any] = {
        "trainable": _trainable(state), "optimizer": state.optimizer.state_dict(),
        "extra": dict(extra or {}),
    }
    if d_state is not None:
        payload["d_trainable"] = _trainable(d_state)
        payload["d_optimizer"] = d_state.optimizer.state_dict()
    if generator is not None:
        payload["generator"] = generator.get_state()
    tmp = os.path.join(path, "state.pt.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, "state.pt"))
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump({"step": int(step)}, f)
    if total_limit:
        for _, old in _ckpt_dirs(output_dir)[:-total_limit]:
            shutil.rmtree(old)
    return path


@torch.no_grad()
def restore_checkpoint(
    path: str, state, d_state=None, generator: Optional[torch.Generator] = None,
) -> Tuple[int, Dict[str, Any]]:
    """Load a checkpoint into `state` (and `d_state`, `generator`) in
    place: the trainable tensors, then the optimizer state, which writes
    each bf16 working copy from its restored master. A trainable tensor
    the checkpoint holds neither itself nor a master of raises. Returns
    (step, the trainer's `extra`)."""
    device = next(iter(state.trainable.values())).device
    payload = torch.load(os.path.join(path, "state.pt"), map_location=device,
                         weights_only=True)

    def load(st, tensors, opt_state):
        lacking = [n for n in st.trainable
                   if n not in tensors and n not in opt_state["masters"]]
        if lacking:
            raise KeyError(f"{path}: no value for {len(lacking)} trainable tensors "
                           f"(first: {lacking[:3]})")
        for n, p in st.trainable.items():
            if n in tensors:
                p.copy_(tensors[n])
        st.optimizer.load_state_dict(opt_state)

    load(state, payload["trainable"], payload["optimizer"])
    if d_state is not None:
        load(d_state, payload["d_trainable"], payload["d_optimizer"])
    if generator is not None:
        generator.set_state(payload["generator"].cpu())
    with open(os.path.join(path, "metadata.json")) as f:
        step = int(json.load(f)["step"])
    return step, payload["extra"]


def diffusers_lora_export_name(name: str) -> Optional[str]:
    """The LoraLoaderMixin key of a port LoRA factor
    ("unet.<module>.lora_a" -> "unet.<module>.lora.down.weight", lora_b
    -> up; "text.<module>.lora_a" ->
    "text_encoder.<module>.lora_linear_layer.down.weight", "text2." ->
    "text_encoder_2."), None for any other tensor."""
    m = _LORA_RE.fullmatch(name)
    if m is not None:
        return f"unet.{m.group(1)}.lora.{'down' if m.group(2) == 'a' else 'up'}.weight"
    m = _TEXT_LORA_RE.fullmatch(name)
    if m is not None:
        dd = "down" if m.group(3) == "a" else "up"
        return f"{_TEXT_ENCODERS[m.group(1)]}.{m.group(2)}.lora_linear_layer.{dd}.weight"
    return None


def _f32(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().float().cpu().numpy()
    return np.ascontiguousarray(value, dtype="<f4")


def save_safetensors(path: str, tensors: Mapping[str, Any]) -> None:
    """fp32 tensors (numpy arrays or torch tensors of any float dtype) in
    the safetensors format: in key order, contiguous, the header padded
    with spaces to a multiple of 8 bytes. Written one tensor at a time,
    so the host holds one tensor's copy at once (a whole UNet under
    --full_finetuning)."""
    header, offset = {}, 0
    for name in sorted(tensors):
        shape = [int(d) for d in tensors[name].shape]
        size = 4 * int(np.prod(shape, dtype=np.int64))
        header[name] = {"dtype": "F32", "shape": shape,
                        "data_offsets": [offset, offset + size]}
        offset += size
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in sorted(tensors):
            f.write(_f32(tensors[name]).tobytes())


_SAFETENSORS_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8",
                       "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a .safetensors file as numpy arrays (the reader of
    `save_safetensors`' format). The file is not read here: each tensor is
    a copy-on-write memory map of its own byte range, so a page is read
    when the array is first touched and is let go when the array is, and
    a caller that drops each tensor after using it holds about one tensor
    of the file in host memory at a time. BF16 is widened to float32
    (exactly), which reads it at once."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        a, b = info["data_offsets"]
        shape = tuple(info["shape"])
        bf16 = info["dtype"] == "BF16"
        dtype = np.dtype("<u2" if bf16 else _SAFETENSORS_DTYPES[info["dtype"]])
        if b == a:
            arr = np.zeros(shape, dtype)
        else:
            arr = np.memmap(path, dtype, mode="c", offset=8 + n + a, shape=shape)
        out[name] = (arr.astype(np.uint32) << 16).view(np.float32) if bf16 else arr
    return out


def export_lora_safetensors(path: str, trainable: Mapping[str, torch.Tensor]) -> None:
    """`pytorch_lora_weights.safetensors` of the trainable tensors (or of
    their fp32 masters, as JAX's trainable leaves are, where the caller
    passes those): the UNet's and the text towers' LoRA factors under
    diffusers' names (`diffusers_lora_export_name`), transposed to torch's
    orientation (the port keeps JAX's lora_a (in, rank) / lora_b (rank,
    out)), in fp32; any other trainable tensor (`--tune_vae`,
    `--tune_text_encoder`, `--full_finetuning`'s UNet) under its port name
    and layout, in fp32, as JAX's fallback writes its tree paths."""
    flat = {}
    for name, t in trainable.items():
        export = diffusers_lora_export_name(name)
        flat[export or name] = t.detach().T if export else t.detach()
    save_safetensors(path, flat)
