"""Model geometry for the PyTorch port (SD1.5 and tiny test geometries).

Port of comat_tpu/config.py (`UNetConfig`, `CLIPTextConfig`, `VAEConfig`)
with torch dtypes. `dtype` is the compute dtype of the frozen weights:
bf16 for SD1.5, fp32 for the tiny CPU geometries.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Geometry of a UNet2DCondition model. `down_block_types`: "cross"
    (CrossAttnDownBlock2D) or "down"; `up_block_types`: "cross" or "up",
    in forward order as in diffusers."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = ("cross", "cross", "cross", "down")
    up_block_types: Tuple[str, ...] = ("up", "cross", "cross", "cross")
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    num_attention_heads: Tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def sd15() -> "UNetConfig":
        return UNetConfig()

    @staticmethod
    def tiny(cross_attention_dim: int = 32) -> "UNetConfig":
        """CPU-runnable test geometry (same topology as SD1.5)."""
        return UNetConfig(
            block_out_channels=(32, 64, 64, 64),
            num_attention_heads=(2, 2, 2, 2),
            cross_attention_dim=cross_attention_dim,
            norm_num_groups=8,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text tower (SD1.5 uses the OpenAI ViT-L/14 text encoder)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    hidden_act: str = "quick_gelu"
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def sd15() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def tiny(vocab_size: int = 1000) -> "CLIPTextConfig":
        return CLIPTextConfig(
            vocab_size=vocab_size,
            hidden_size=32,
            intermediate_size=64,
            num_layers=2,
            num_heads=2,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL geometry; SD1.5 latents are scaled by 0.18215."""

    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def sd15() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(
            block_out_channels=(16, 32, 32, 32),
            layers_per_block=1,
            norm_num_groups=8,
            dtype=torch.float32,
        )
