"""8-bit AdamW: both Adam moments stored as int8 codes with one fp32
absmax scale per block of 2048 values (--use_8bit_adam).

The port's copy of comat_tpu/training/optim8bit.py (`_quantize`,
`_dequantize`, `scale_by_adam_8bit`, `adamw_8bit`), the counterpart of the
reference's bitsandbytes AdamW8bit (training_script.py:216-223). Each step
dequantizes a tensor's moments, updates them and the parameter in fp32
exactly as AdamW does, and quantizes them again: the codes are
round(x / absmax * 127) of each block, linear, as JAX's are (bitsandbytes
uses a dynamic, non-linear code map; the port follows JAX). The update is
optax's chain: scale_by_adam on the dequantized moments, then the weight
decay added to the update, then the learning rate, so a step is
p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p).

Optimizer state per parameter: `step` and the codes and scales of both
moments (`mu_q`, `mu_scale`, `nu_q`, `nu_scale`), in the optimizer's state
dict and so in checkpoints; the codes stay int8 through
`load_state_dict`. Plain PyTorch: JAX computes this in XLA, outside any
Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

BLOCK = 2048
_CODES = ("mu_q", "nu_q")


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 tensor -> (int8 codes (nblocks, BLOCK), fp32 absmax scales
    (nblocks,)): JAX's `_quantize`, the tail block padded with zeros and
    an all-zero block's scale 0."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.view(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe * 127.0), -127, 127)
    return q.to(torch.int8), scale[:, 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`quantize`'s inverse, cut to `shape`: JAX's `_dequantize`."""
    x = (q.float() / 127.0) * scale[:, None]
    n = 1
    for s in shape:
        n *= s
    return x.reshape(-1)[:n].reshape(tuple(shape))


class AdamW8bit(torch.optim.Optimizer):
    """AdamW with int8 blockwise moments (JAX's `adamw_8bit`), a drop-in
    for `torch.optim.AdamW` over fp32 tensors: the same constructor
    keywords, param groups and per-group learning rates. A tensor without
    a gradient is skipped."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW8bit takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    nblocks = -(-p.numel() // BLOCK)
                    st["step"] = 0
                    for m in ("mu", "nu"):
                        st[f"{m}_q"] = torch.zeros((nblocks, BLOCK), dtype=torch.int8,
                                                   device=p.device)
                        st[f"{m}_scale"] = torch.zeros((nblocks,), dtype=torch.float32,
                                                       device=p.device)
                st["step"] += 1
                # the bias corrections in fp32, as JAX's count.astype(float32)
                count = torch.tensor(float(st["step"]), dtype=torch.float32)
                bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
                bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)
                g = p.grad.float()
                m = dequantize(st["mu_q"], st["mu_scale"], p.shape)
                v = dequantize(st["nu_q"], st["nu_scale"], p.shape)
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                st["mu_q"], st["mu_scale"] = quantize(m)
                st["nu_q"], st["nu_scale"] = quantize(v)
                p.add_((update + wd * p) * -lr)

    def state_bytes(self) -> int:
        """Bytes of the moments' codes and scales."""
        return sum(t.numel() * t.element_size() for st in self.state.values()
                   for k, t in st.items() if isinstance(t, torch.Tensor))

    def load_state_dict(self, state_dict: Dict[str, object]) -> None:
        """`torch.optim.Optimizer.load_state_dict`, which casts every
        floating parameter's state to the parameter's dtype, with the int8
        codes kept as they are."""
        state = {pid: dict(st) for pid, st in state_dict["state"].items()}
        codes = {pid: {k: st.pop(k) for k in _CODES if k in st} for pid, st in state.items()}
        super().load_state_dict({**state_dict, "state": state})
        ids = [pid for g in state_dict["param_groups"] for pid in g["params"]]
        params = [p for g in self.param_groups for p in g["params"]]
        for pid, p in zip(ids, params):
            for k, q in codes.get(pid, {}).items():
                self.state[p][k] = q.to(device=p.device, dtype=torch.int8)
