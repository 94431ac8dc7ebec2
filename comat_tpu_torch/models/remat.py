"""Block-level gradient checkpointing (remat), the port's counterpart of
the JAX package's `nn.remat` blocks (--gradient_checkpointing).

A checkpointed block keeps only its inputs for the backward and runs its
forward again there. It is non-reentrant `torch.utils.checkpoint`, which
re-runs every custom autograd Function of the block (the flash-attention
and conv kernels' wrappers) and takes their saved tensors from the
recompute. Outside autograd (no_grad, pass 1) a block runs as it is.
"""

from __future__ import annotations

from typing import Callable, Union

import torch
from torch.utils.checkpoint import checkpoint

Remat = Union[bool, int, None]


def remat_at(remat: Remat, res: int) -> bool:
    """JAX's `_remat_at` (comat_tpu/models/unet.py): every block for
    True, none for False/None/0, those at spatial resolution >= R for an
    int R."""
    if remat is True:
        return True
    if not remat:
        return False
    return res >= int(remat)


def call(fn: Callable, *args, remat: bool):
    """fn(*args), checkpointed where `remat` is set and autograd records.
    The blocks hold no random ops, so no RNG state is stashed."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)
