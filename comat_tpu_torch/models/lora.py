"""LoRA-augmented linear layer, LoRA folding and the LoRA/frozen split.

Port of comat_tpu/models/lora.py (`LoRADense`, `fuse_lora_tree`,
`is_lora_path`, `split_lora_params`, `merge_params`). The
frozen projection lives under `base` (an nn.Linear); the factors
`lora_a` (in, r) and `lora_b` (r, out) are fp32 master weights in the
JAX layout, and the branch runs in the base's compute dtype:
y = base(x) + (x A) B. The base is a `QLinear` (models/quant.py): under an
installed int8 weight set it runs int8 and the LoRA branch stays in the
layer's dtype beside it, as JAX's `LoRADense` over a `QDense`.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch
from torch import nn

from comat_tpu_torch.models.quant import QLinear


class LoRALinear(nn.Module):
    """nn.Linear under `base` plus an optional rank-`lora_rank` branch.
    `lora_rank == 0` makes it a plain linear layer with no factors."""

    def __init__(
        self, in_features: int, out_features: int, bias: bool = True,
        lora_rank: int = 0, dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.base = QLinear(
            in_features, out_features, bias=bias, dtype=dtype, device=device
        )
        self.lora_rank = lora_rank
        if lora_rank > 0:
            self.lora_a = nn.Parameter(torch.empty(
                in_features, lora_rank, dtype=torch.float32, device=device
            ))
            self.lora_b = nn.Parameter(torch.empty(
                lora_rank, out_features, dtype=torch.float32, device=device
            ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.base(x)
        if self.lora_rank > 0:
            dt = self.base.weight.dtype
            delta = (x.to(dt) @ self.lora_a.to(dt)) @ self.lora_b.to(dt)
            y = y + delta.to(y.dtype)
        return y


def fuse_lora(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold every LoRA branch into its base weight: W_eff = W + (A B)^T,
    summed in fp32 and cast back to W's dtype. The result has no
    `lora_a`/`lora_b` entries and loads into a `lora_rank=0` twin of the
    same module."""
    out = {}
    for name, value in state_dict.items():
        if name.endswith(".lora_a") or name.endswith(".lora_b"):
            continue
        prefix = name[: -len(".base.weight")] if name.endswith(".base.weight") else None
        if prefix is not None and prefix + ".lora_a" in state_dict:
            a = state_dict[prefix + ".lora_a"].float()
            b = state_dict[prefix + ".lora_b"].float()
            value = (value.float() + (a @ b).T).to(value.dtype)
        out[name] = value
    return out


def is_lora_path(path: Iterable[str]) -> bool:
    """True if a parameter path (a dotted name or a tuple of its parts)
    names a LoRA factor."""
    parts = path.split(".") if isinstance(path, str) else path
    return any(str(k).startswith("lora_") for k in parts)


def split_lora_params(
    state_dict: Dict[str, torch.Tensor],
) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"lora": the LoRA factors, "frozen": everything else}, by name."""
    out: Dict[str, Dict[str, torch.Tensor]] = {"lora": {}, "frozen": {}}
    for name, value in state_dict.items():
        out["lora" if is_lora_path(name) else "frozen"][name] = value
    return out


def merge_params(
    trainable: Dict[str, torch.Tensor], frozen: Dict[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """One state dict from a (trainable, frozen) split; the two must not
    share a name."""
    both = trainable.keys() & frozen.keys()
    if both:
        raise ValueError(f"{len(both)} names on both sides, e.g. {sorted(both)[0]}")
    return {**frozen, **trainable}
