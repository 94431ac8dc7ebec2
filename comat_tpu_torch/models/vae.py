"""The VAE (AutoencoderKL) in PyTorch: the decoder the train step
differentiates through, and the encoder.

Port of comat_tpu/models/vae.py (`VAEDecoder`, `VAEEncoder`,
`AutoencoderKL`). The 3x3 stride-1 convs are `Conv3x3` modules, so the
large ones go to the conv kernel; the single-head mid-block attention goes
through `multi_head_attention(num_heads=1)`, so the 4096-token one at
512^2 goes to the flash-attention kernel. GroupNorm eps is 1e-6
throughout. Parameter names follow diffusers' AutoencoderKL
(`encoder.{conv_in, down_blocks, mid_block, conv_norm_out, conv_out}`,
`quant_conv`, `post_quant_conv`, `decoder.{conv_in, mid_block, up_blocks,
conv_norm_out, conv_out}`). `decode(..., remat=True)` checkpoints each
decoder resnet block, as JAX's `remat_blocks` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from comat_tpu_torch.config import VAEConfig
from comat_tpu_torch.models import remat as rm
from comat_tpu_torch.models.conv import Conv3x3
from comat_tpu_torch.ops.attention import multi_head_attention


class VAEResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6, **kw)
        self.conv1 = Conv3x3(cin, cout, **kw)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6, **kw)
        self.conv2 = Conv3x3(cout, cout, **kw)
        self.conv_shortcut = (
            nn.Conv2d(cin, cout, 1, **kw) if cin != cout else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial self-attention at the bottleneck."""

    def __init__(self, ch: int, groups: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6, **kw)
        self.to_q = nn.Linear(ch, ch, **kw)
        self.to_k = nn.Linear(ch, ch, **kw)
        self.to_v = nn.Linear(ch, ch, **kw)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch, **kw)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        o = multi_head_attention(self.to_q(h), self.to_k(h), self.to_v(h), 1)
        o = self.to_out[0](o)
        return x + o.reshape(B, H, W, C).permute(0, 3, 1, 2)


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.resnets = nn.ModuleList([
            VAEResnetBlock(ch, ch, groups, **kw),
            VAEResnetBlock(ch, ch, groups, **kw),
        ])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups, **kw)])

    def forward(self, h: torch.Tensor, remat: bool = False) -> torch.Tensor:
        h = rm.call(self.resnets[0], h, remat=remat)
        h = self.attentions[0](h)
        return rm.call(self.resnets[1], h, remat=remat)


class _Upsampler(nn.Module):
    def __init__(self, ch: int, dtype, device=None):
        super().__init__()
        self.conv = Conv3x3(ch, ch, dtype=dtype, device=device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))


class _UpBlock(nn.Module):
    def __init__(self, cin: int, ch: int, layers: int, groups: int,
                 upsample: bool, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.resnets = nn.ModuleList([
            VAEResnetBlock(cin if j == 0 else ch, ch, groups, **kw)
            for j in range(layers)
        ])
        self.upsamplers = (
            nn.ModuleList([_Upsampler(ch, **kw)]) if upsample else None
        )

    def forward(self, h: torch.Tensor, remat: bool = False) -> torch.Tensor:
        for resnet in self.resnets:
            h = rm.call(resnet, h, remat=remat)
        if self.upsamplers is not None:
            h = self.upsamplers[0](h)
        return h


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        g = cfg.norm_num_groups
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = Conv3x3(cfg.latent_channels, rev[0], **kw)
        self.mid_block = _MidBlock(rev[0], g, **kw)
        self.up_blocks = nn.ModuleList()
        cur = rev[0]
        for i, ch in enumerate(rev):
            self.up_blocks.append(_UpBlock(
                cur, ch, cfg.layers_per_block + 1, g, i < len(rev) - 1, **kw
            ))
            cur = ch
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6, **kw)
        # the output conv runs in fp32, as in the JAX module
        self.conv_out = Conv3x3(rev[-1], cfg.in_channels,
                                dtype=torch.float32, device=device)

    def forward(self, z: torch.Tensor, remat: bool = False) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z), remat)
        for block in self.up_blocks:
            h = block(h, remat)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class _Downsampler(nn.Module):
    """3x3 stride-2 conv after padding one row and column at the bottom
    and right (JAX: padding ((0, 1), (0, 1)))."""

    def __init__(self, ch: int, dtype, device=None):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, dtype=dtype, device=device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(h, (0, 1, 0, 1)))


class _DownBlock(nn.Module):
    def __init__(self, cin: int, ch: int, layers: int, groups: int,
                 downsample: bool, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.resnets = nn.ModuleList([
            VAEResnetBlock(cin if j == 0 else ch, ch, groups, **kw)
            for j in range(layers)
        ])
        self.downsamplers = (
            nn.ModuleList([_Downsampler(ch, **kw)]) if downsample else None
        )

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            h = resnet(h)
        if self.downsamplers is not None:
            h = self.downsamplers[0](h)
        return h


class Encoder(nn.Module):
    """image (B, C, H, W) -> the moments (B, 2 * latent_channels, H/8,
    W/8) before `quant_conv`; the output conv runs in fp32, as in JAX."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        g = cfg.norm_num_groups
        chs = cfg.block_out_channels
        self.conv_in = Conv3x3(cfg.in_channels, chs[0], **kw)
        self.down_blocks = nn.ModuleList()
        cur = chs[0]
        for i, ch in enumerate(chs):
            self.down_blocks.append(_DownBlock(
                cur, ch, cfg.layers_per_block, g, i < len(chs) - 1, **kw))
            cur = ch
        self.mid_block = _MidBlock(chs[-1], g, **kw)
        self.conv_norm_out = nn.GroupNorm(g, chs[-1], eps=1e-6, **kw)
        self.conv_out = Conv3x3(chs[-1], 2 * cfg.latent_channels,
                                dtype=torch.float32, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """The pipeline's VAE. `decode` (also `forward`): latents (B, h, w,
    4), already divided by the scaling factor -> image in [-1, 1]
    (B, 8h, 8w, 3), fp32. `encode`: image (B, H, W, 3) in [-1, 1] ->
    (mean, logvar), each (B, H/8, W/8, 4) in fp32, logvar clipped to
    [-30, 20]."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        lat = cfg.latent_channels
        self.encoder = Encoder(cfg, device)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1, dtype=torch.float32,
                                    device=device)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1, dtype=cfg.dtype,
                                         device=device)
        self.decoder = Decoder(cfg, device)

    def decode(self, latents: torch.Tensor, remat: bool = False) -> torch.Tensor:
        z = latents.to(self.cfg.dtype).permute(0, 3, 1, 2)
        img = self.decoder(self.post_quant_conv(z), remat)
        return img.permute(0, 2, 3, 1)

    forward = decode

    def encode(self, images: torch.Tensor):
        x = images.to(self.cfg.dtype).permute(0, 3, 1, 2)
        moments = self.quant_conv(self.encoder(x).float()).permute(0, 2, 3, 1)
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)
