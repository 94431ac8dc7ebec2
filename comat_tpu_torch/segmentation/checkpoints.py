"""Checkpoint files of the segmentation models.

Port of comat_tpu/segmentation/checkpoints.py (`load_torch_state_dict`,
`load_fastsam_checkpoint`, `load_gdino_checkpoint`). The reference loads
FastSAM-x.pt through ultralytics and groundingdino_swint_ogc.pth through
the GroundingDINO package (attr_concen_utils/gsam_interface.py:24-37).
The port's modules carry those files' own parameter names and torch
layouts, so loading is `load_state_dict`: none of the JAX importers'
transposes, q/k/v splits, patch-merge permutation or ConvTranspose tap
flip applies.

Handled layouts: a raw state dict; a {"model": ...} / {"state_dict": ...}
/ {"ema": ...} wrapper (the GroundingDINO release uses "model"); an
ultralytics checkpoint whose "model" is a pickled nn.Module (unpickling
it needs the ultralytics package; without it the loader says how to
re-export the file as a plain state dict). A "module." prefix (a DDP
save) is stripped.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch
from torch import nn

# buffers a checkpoint may hold that the port's modules compute instead
_DERIVED = ("relative_position_index", "num_batches_tracked", "position_ids")


def _looks_flat(d: dict) -> bool:
    """True if d already maps names to tensors (not a wrapper)."""
    return any(hasattr(v, "shape") for v in d.values())


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A .pt / .pth file -> {name: fp32 CPU tensor}, unwrapped, without a
    "module." prefix."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # pickled-module checkpoints (ultralytics) need full unpickling
        try:
            obj = torch.load(path, map_location="cpu", weights_only=False)
        except ModuleNotFoundError as e:
            raise RuntimeError(
                f"{path} pickles classes from {e.name!r}, which is not installed. "
                "Re-export it as a plain state dict first: "
                "torch.save(ckpt['model'].state_dict(), out) on a machine that has "
                "the package.") from e
    for key in ("model", "state_dict", "ema"):
        if isinstance(obj, dict) and key in obj and not _looks_flat(obj):
            obj = obj[key]
            break
    if hasattr(obj, "state_dict"):  # an nn.Module (ultralytics)
        obj = obj.state_dict()
    if not isinstance(obj, dict):
        raise ValueError(f"unrecognized checkpoint layout in {path}")
    return {(k[len("module."):] if k.startswith("module.") else k):
            v.detach().float().cpu() for k, v in obj.items() if hasattr(v, "shape")}


def load_into(module: nn.Module, state: Dict[str, torch.Tensor]
              ) -> Tuple[List[str], List[str]]:
    """Load `state` into `module` where names and shapes match. Returns
    (missing: the module's tensors the file lacks, unused: the file's
    tensors the module has no place for), buffers the module derives
    itself left out of both. A tensor of the right name and wrong shape
    raises."""
    own = module.state_dict()
    for name, t in state.items():
        if name in own and tuple(own[name].shape) != tuple(t.shape):
            raise ValueError(f"{name}: checkpoint {tuple(t.shape)}, "
                             f"module {tuple(own[name].shape)}")
    result = module.load_state_dict(state, strict=False)
    derived = lambda n: n.rsplit(".", 1)[-1] in _DERIVED  # noqa: E731
    return ([n for n in result.missing_keys if not derived(n)],
            [n for n in result.unexpected_keys if not derived(n)])


def load_fastsam_checkpoint(path: str, model: nn.Module) -> Tuple[List[str], List[str]]:
    """FastSAM-x.pt into a `YoloV8Seg`. The raw file names layers
    "model.model.{idx}..." (the outer "model" key and DetectionModel's
    Sequential); the port's module, like a state dict taken from the
    DetectionModel itself, names them "model.{idx}...". The head's DFL
    conv (fixed weights; the port integrates on the host) is unused."""
    sd = load_torch_state_dict(path)
    sd = {(k[len("model."):] if re.match(r"model\.model\.\d+\.", k) else k): v
          for k, v in sd.items()}
    return load_into(model, sd)


def load_gdino_checkpoint(path: str, model: nn.Module) -> Tuple[List[str], List[str]]:
    """groundingdino_swint_ogc.pth into a `GroundingDetector`."""
    return load_into(model, load_torch_state_dict(path))
