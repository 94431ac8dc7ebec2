"""Checkpoint save and resume, and the LoRA export.

The port's counterpart of comat_tpu/training/checkpoints.py. The
reference's layout (training_script.py:382-426, 156-205):
`<output_dir>/checkpoint-{step}/` directories, a `latest` resume that
sorts them by step, and `checkpoints_total_limit` pruning of the oldest.
A checkpoint holds, beside `metadata.json` ({"step": n}), one `state.pt`
(torch.save): the generator's and the discriminator's trainable tensors,
the optimizers' state (the fp32 masters of bf16 tensors, AdamW's moments
and steps, the update count), the `torch.Generator` state the step draws
come from (the counterpart of the JAX rng key) and what the trainer adds
(`extra`). Single process: no barriers.

`export_lora_safetensors` writes `pytorch_lora_weights.safetensors` with
the reference's keys and orientation (`unet.<module>.lora.{down,up}.weight`,
down (rank, in), up (out, rank)), the port's copy of JAX's
`export_lora_safetensors` and `hf_import.diffusers_lora_export_name`.
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
    return {n: p.detach() for n, p in state.trainable.items()}


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
    each bf16 working copy from its restored master. Returns (step, the
    trainer's `extra`)."""
    device = next(iter(state.trainable.values())).device
    payload = torch.load(os.path.join(path, "state.pt"), map_location=device,
                         weights_only=True)
    for n, p in state.trainable.items():
        p.copy_(payload["trainable"][n])
    state.optimizer.load_state_dict(payload["optimizer"])
    if d_state is not None:
        for n, p in d_state.trainable.items():
            p.copy_(payload["d_trainable"][n])
        d_state.optimizer.load_state_dict(payload["d_optimizer"])
    if generator is not None:
        generator.set_state(payload["generator"].cpu())
    with open(os.path.join(path, "metadata.json")) as f:
        step = int(json.load(f)["step"])
    return step, payload["extra"]


def diffusers_lora_export_name(name: str) -> Optional[str]:
    """The LoraLoaderMixin key of a port LoRA factor
    ("unet.<module>.lora_a" -> "unet.<module>.lora.down.weight", lora_b
    -> up), None for any other tensor."""
    m = _LORA_RE.fullmatch(name)
    if m is None:
        return None
    return f"unet.{m.group(1)}.lora.{'down' if m.group(2) == 'a' else 'up'}.weight"


def save_safetensors(path: str, tensors: Mapping[str, np.ndarray]) -> None:
    """fp32 tensors in the safetensors format: in key order, contiguous,
    the header padded with spaces to a multiple of 8 bytes."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name], dtype="<f4")
        data = arr.tobytes()
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for data in blobs:
            f.write(data)


_SAFETENSORS_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8",
                       "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a .safetensors file as numpy arrays (the reader of
    `save_safetensors`' format; BF16 comes back as float32, exactly)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        a, b = info["data_offsets"]
        raw, shape = data[a:b], tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
        else:
            out[name] = np.frombuffer(raw, _SAFETENSORS_DTYPES[info["dtype"]]).reshape(shape)
    return out


def export_lora_safetensors(path: str, trainable: Mapping[str, torch.Tensor]) -> None:
    """`pytorch_lora_weights.safetensors` of the trainable tensors: the
    UNet LoRA factors under diffusers' names, transposed to torch's
    orientation (the port keeps JAX's lora_a (in, rank) / lora_b
    (rank, out)), in fp32; any other trainable tensor (`--tune_vae`,
    `--tune_text_encoder`) under its port name and layout, in fp32."""
    flat = {}
    for name, t in trainable.items():
        arr = t.detach().float().cpu().numpy()
        export = diffusers_lora_export_name(name)
        flat[export or name] = arr.T if export else arr
    save_safetensors(path, flat)
