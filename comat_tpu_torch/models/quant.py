"""Opt-in W8A8 int8 numerics for the no-grad pass-1 UNet forwards
(--pass1_int8).

Port of comat_tpu/models/quant.py (`QDense`, `QDenseGeneral`, `QConv`,
`_quantizable`, `_weight_quant`, `quantize_unet_tree`): dynamic W8A8 with
symmetric per-output-channel int8 weights, quantized once per step, int8
activations scaled per token for the linear layers (the GEGLU projection
included: its flat (8d, dim) weight gets one scale a row, JAX's (2, 4d)
scale in the [values, gates] order) and per sample over (C, H, W) for the
convs, int32 sums, and the dequantize and bias in fp32 (ops/quant.py holds
the arithmetic and the kernels).

JAX dispatches on the kernel's dtype inside one tree; the port shares its
modules between pass 1, the replay, the capture and the discriminator, so
the int8 weight set is never stored in a module's state: `quantize_unet`
makes it from the UNet's weights as they stand (the fused twin's, or the
LoRA'd UNet's base weights, its LoRA branch staying in the layer's dtype
beside the int8 base, as JAX's unfused int8 path), and `installed` hands it
to the `QLinear` / `QConv2d` modules for the length of a `with` block and
takes it back after, whatever happens inside. Outside such a block the
modules are nn.Linear and nn.Conv2d, bit for bit; `state_dict` never holds
the int8 tensors.

Never quantized (JAX's `_quantizable` rule on diffusers names): any layer
under `time_embedding`, `add_embedding` or `time_emb_proj`, the modules
`conv_in` and `conv_out`, and the LoRA factors (no linear layers); norms
and the attention products stay in the layer's dtype.

Under tensor parallelism (`parallel.tp.apply_tp`) a column-parallel layer
quantizes as it is (its input is whole, its weight rows and their scales
its own); a row-parallel one (`row_group` set) takes its weight scales
and each token's activation scale over the whole row, by MAX all-reduces
over its model group, and sums its int32 products over the group before
the dequantize and the bias: JAX's W8A8, whose absmax GSPMD takes over the
whole logical tensor, so the sharded UNet's codes and outputs are the
unsharded one's bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, NamedTuple, Optional

import torch
from torch import nn

from comat_tpu_torch.ops.quant import int8_conv, int8_linear, quantize

_SKIP_SUBSTRINGS = ("time_embedding", "add_embedding", "time_emb_proj")
_SKIP_EXACT_MODULES = ("conv_in", "conv_out")


class W8A8Weight(NamedTuple):
    """A layer's int8 weight: codes (N, K) int8, K in (dy, dx, c) order for a
    conv; per-output-channel scales (N,) fp32; the bias in fp32 or None."""

    q: torch.Tensor
    scale: torch.Tensor
    bias: Optional[torch.Tensor]


class QLinear(nn.Linear):
    """nn.Linear with JAX's `QDense` int8 branch, taken while `installed`
    has given it a weight set. `row_group` is set by `parallel.tp` on a
    row-parallel layer: its weight columns and its input's features are
    this rank's block of that group's."""

    w8a8: Optional[W8A8Weight] = None
    row_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.w8a8 is None:
            return super().forward(x)
        return int8_linear(x, *self.w8a8, self.weight.dtype, group=self.row_group)


class QConv2d(nn.Conv2d):
    """nn.Conv2d (square kernel, equal strides and padding) with JAX's
    `QConv` int8 branch, taken while `installed` has given it a weight set."""

    w8a8: Optional[W8A8Weight] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.w8a8 is None:
            return super().forward(x)
        return int8_conv(x, *self.w8a8, self.kernel_size[0], self.stride[0],
                         self.padding[0], self.weight.dtype)


def quantizable(name: str) -> bool:
    """JAX's `_quantizable` on a diffusers module name: False under the
    time and added embeddings and for conv_in / conv_out."""
    parts = name.split(".")
    if any(s in p for s in _SKIP_SUBSTRINGS for p in parts):
        return False
    return parts[-1] not in _SKIP_EXACT_MODULES


@torch.no_grad()
def weight_quant(weight: torch.Tensor, group=None) -> tuple:
    """JAX's `_weight_quant`: (codes, scales) per output channel of a
    linear (N, K) or conv (Cout, C, kh, kw) weight; a conv's codes are laid
    out (Cout, kh*kw*C), the int8 conv's K-major order. With `group` the
    weight is a row-parallel shard: each channel's scale is its whole
    row's."""
    w2 = weight if weight.dim() == 2 else weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1)
    if group is None:
        return quantize(w2.contiguous(), w2.shape[0], role="weight")
    return quantize(w2.contiguous(), w2.shape[0], role="weight", group=group)


@torch.no_grad()
def quantize_unet(unet: nn.Module) -> Dict[str, W8A8Weight]:
    """The int8 weight set of a UNet as its weights stand: {module name:
    W8A8Weight} for every quantizable linear and conv layer (JAX's
    `quantize_unet_tree`), a UNet sharded by `parallel.tp` included (each
    rank's set holds its shards' codes, scaled as the whole weight's)."""
    out = {}
    for name, module in unet.named_modules():
        if not (isinstance(module, (nn.Linear, nn.Conv2d)) and quantizable(name)):
            continue
        if not isinstance(module, (QLinear, QConv2d)):
            raise TypeError(f"{name}: a quantizable {type(module).__name__} without "
                            "the int8 branch")
        q, s = weight_quant(module.weight, getattr(module, "row_group", None))
        bias = None if module.bias is None else module.bias.detach().float()
        out[name] = W8A8Weight(q, s, bias)
    return out


@contextlib.contextmanager
def installed(unet: nn.Module, weights: Dict[str, W8A8Weight]) -> Iterator[None]:
    """Run `unet`'s quantized layers through their int8 branch inside the
    block; every layer is plain again after it."""
    modules = dict(unet.named_modules())
    try:
        for name, w in weights.items():
            modules[name].w8a8 = w
        yield
    finally:
        for name in weights:
            modules[name].w8a8 = None


@contextlib.contextmanager
def pass1_w8a8(unet: nn.Module, int8: bool) -> Iterator[None]:
    """With `int8`, quantize `unet` as it stands and run the block on the
    int8 weight set, which is freed after it; without, do nothing."""
    if not int8:
        yield
        return
    with installed(unet, quantize_unet(unet)):
        yield
