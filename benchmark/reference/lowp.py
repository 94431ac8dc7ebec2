"""The reference computed in float8: the control of the trainer cells.

The configuration serves the towers in bfloat16; the nearest precision
below it is float8 (e4m3), the precision Hopper's tensor cores take next.
`lower(module)` makes every linear layer and convolution of `module` (the
UNet's LoRA path included) compute on operands rounded to e4m3: the
activation with a scale per row (per token, per pixel), the weight with
a scale per output channel, each scale the slice's largest magnitude over
e4m3's largest finite value (448). Products and sums stay float32, as a
float8 GEMM accumulates; the gradient passes the rounding unchanged.
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0


def fp8(x: torch.Tensor, dims) -> torch.Tensor:
    """`x` rounded to e4m3 under one scale per slice (the largest
    magnitude over `dims`), back in x's dtype; the gradient of the
    rounding is the identity."""
    xd = x.detach()
    scale = xd.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    q = (xd / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - xd)


def _linear(self, x):
    xq = fp8(x, -1)
    y = F.linear(xq, fp8(self.weight, 1), self.bias)
    lora = getattr(self, "lora", None)
    if lora is not None:
        a, b = lora
        y = y + fp8(xq @ fp8(a, 0), -1) @ fp8(b, 0)
    return y


def _conv(self, x):
    return F.conv2d(fp8(x, 1), fp8(self.weight, (1, 2, 3)), self.bias, self.stride,
                    self.padding, self.dilation, self.groups)


def lower(module: nn.Module) -> nn.Module:
    """Every nn.Linear and nn.Conv2d of `module` computed in float8, in
    place."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.forward = types.MethodType(_linear, m)
        elif isinstance(m, nn.Conv2d):
            m.forward = types.MethodType(_conv, m)
    return module
