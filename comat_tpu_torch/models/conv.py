"""3x3 SAME conv module with kernel dispatch.

Port of comat_tpu/models/conv.py (`Conv3x3`). Parameters are
nn.Conv2d's: `weight` (Cout, C, 3, 3) and `bias` (Cout,). Shapes that
pass `use_conv_kernel` go to `conv3x3_same` (the CUDA kernels on the
card, forward and, where autograd records, dx and dw; the plain versions
on the CPU); the rest to F.conv2d. The bias is added outside the kernel,
as in the JAX module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from comat_tpu_torch.ops.conv3x3 import conv3x3_same, use_conv_kernel


class Conv3x3(nn.Conv2d):
    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_channels, out_channels, 3, padding=1,
                         dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W), best in channels_last memory (NHWC), which the
        kernel reads without a copy."""
        x = x.to(self.weight.dtype)
        B, C, H, W = x.shape
        w_shape = (3, 3, C, self.out_channels)
        if use_conv_kernel((B, H, W, C), w_shape):
            x_nhwc = x.permute(0, 2, 3, 1).contiguous()
            w_hwio = self.weight.permute(2, 3, 1, 0).contiguous()
            y = conv3x3_same(x_nhwc, w_hwio).permute(0, 3, 1, 2)
        else:
            y = F.conv2d(x, self.weight, None, padding=1)
        return y + self.bias[:, None, None]
