"""Swin Transformer backbone (Swin-T): GroundingDINO's image tower.

Port of comat_tpu/segmentation/swin.py (`SwinConfig`, `_window_partition`,
`_window_merge`, `_relative_position_index`, `WindowAttention`,
`SwinBlock`, `SwinBackbone`). Standard Swin v1: 4x4 patch embedding,
W-MSA / SW-MSA with a relative position bias, patch merging; it returns
the stage 2/3/4 maps (strides 8/16/32) that GroundingDINO consumes.

Tokens are NHWC. Parameter names are those of the IDEA GroundingDINO
release's `backbone.0` (`patch_embed.proj`, `layers.{i}.blocks.{j}.attn.qkv`,
`layers.{i}.downsample.reduction`, `norm{i}`, ...), so a checkpoint loads
with `load_state_dict`; patch merging therefore concatenates the 2x2
sub-pixels in torch's order (x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2],
x[1::2, 1::2]). As in JAX, maps are zero-padded to window multiples
(padded pixels take part in the windowed softmax; only the shift mask
applies) and cropped back, the shift mask adds -1e9, and the MLP's GELU
is exact.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from comat_tpu_torch.segmentation.layers import Conv2d, Dense, LayerNorm


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny_test() -> "SwinConfig":
        return SwinConfig(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 2, 4),
                          window=4, dtype=torch.float32)


def _window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def _window_merge(win: torch.Tensor, w: int, B: int, H: int, W: int) -> torch.Tensor:
    C = win.shape[-1]
    x = win.reshape(B, H // w, W // w, w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def _relative_position_index(w: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, dtype: torch.dtype):
        super().__init__()
        self.heads, self.window = heads, window
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_relative_position_index(window)),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        nW, N, C = x.shape
        hd = C // self.heads
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        split = lambda a: a.reshape(nW, N, self.heads, hd).transpose(1, 2)  # noqa: E731
        logits = torch.matmul(split(q).float(), split(k).float().transpose(-1, -2)) / hd ** 0.5
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        logits = logits + bias.reshape(N, N, self.heads).permute(2, 0, 1)[None]
        if mask is not None:     # (nW per image, N, N), additive
            n_img = mask.shape[0]
            logits = (logits.reshape(-1, n_img, self.heads, N, N)
                      + mask[None, :, None]).reshape(nW, self.heads, N, N)
        p = torch.softmax(logits, dim=-1)
        o = torch.matmul(p.to(v.dtype), split(v))
        return self.proj(o.transpose(1, 2).reshape(nW, N, C))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float,
                 dtype: torch.dtype):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = WindowAttention(dim, heads, window, dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        w, s = self.window, self.shift
        Hp, Wp = -(-H // w) * w, -(-W // w) * w
        h = self.norm1(x)
        if Hp != H or Wp != W:
            h = F.pad(h, (0, 0, 0, Wp - W, 0, Hp - H))
        mask = None
        if s:
            h = torch.roll(h, (-s, -s), dims=(1, 2))
            mask = self._attn_mask(Hp, Wp, x.device)
        win = self.attn(_window_partition(h, w), mask)
        h = _window_merge(win, w, B, Hp, Wp)
        if s:
            h = torch.roll(h, (s, s), dims=(1, 2))
        if Hp != H or Wp != W:
            h = h[:, :H, :W]
        x = x + h
        return x + self.mlp(self.norm2(x))

    def _attn_mask(self, H: int, W: int, device) -> torch.Tensor:
        w, s = self.window, self.shift
        img = np.zeros((H, W), np.int64)
        cnt = 0
        for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
                img[hs, ws] = cnt
                cnt += 1
        win = _window_partition(torch.from_numpy(img)[None, :, :, None], w)[..., 0]
        diff = win[:, None, :] != win[:, :, None]
        return torch.where(diff, -1e9, 0.0).to(device, torch.float32)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.proj = Conv2d(3, dim, 4, stride=4, dtype=dtype)
        self.norm = LayerNorm(dim, dtype=dtype)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """image NHWC -> tokens NHWC at stride 4 (flax's SAME padding)."""
        x = image.permute(0, 3, 1, 2)
        H, W = x.shape[2:]
        ph, pw = -H % 4, -W % 4
        if ph or pw:
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.norm = LayerNorm(4 * dim, dtype=dtype)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1:3]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class _Stage(nn.Module):
    def __init__(self, cfg: SwinConfig, stage: int, dim: int):
        super().__init__()
        heads = cfg.num_heads[stage]
        self.blocks = nn.ModuleList([
            SwinBlock(dim, heads, cfg.window, 0 if blk % 2 == 0 else cfg.window // 2,
                      cfg.mlp_ratio, cfg.dtype)
            for blk in range(cfg.depths[stage])])
        if stage < len(cfg.depths) - 1:
            self.downsample = PatchMerging(dim, cfg.dtype)


class SwinBackbone(nn.Module):
    """image (B, H, W, 3) -> [stage2, stage3, stage4] maps, NHWC."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.embed_dim, cfg.dtype)
        dims = [cfg.embed_dim * 2 ** i for i in range(len(cfg.depths))]
        self.layers = nn.ModuleList([_Stage(cfg, i, d) for i, d in enumerate(dims)])
        for i in range(1, len(dims)):
            self.add_module(f"norm{i}", LayerNorm(dims[i], dtype=cfg.dtype))

    def forward(self, image: torch.Tensor) -> List[torch.Tensor]:
        x = self.patch_embed(image.to(self.cfg.dtype))
        outs = []
        for i, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x)
            if i >= 1:
                outs.append(getattr(self, f"norm{i}")(x))
            if hasattr(stage, "downsample"):
                x = stage.downsample(x)
        return outs
