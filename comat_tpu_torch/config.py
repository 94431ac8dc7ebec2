"""Model geometry for the PyTorch port (SD1.5, SDXL and tiny test
geometries).

Port of comat_tpu/config.py (`UNetConfig`, `CLIPTextConfig`, `VAEConfig`,
`BLIPConfig`) with torch dtypes. `dtype` is the compute dtype of the
frozen weights: bf16 for SD1.5, SDXL and BLIP-large, fp32 for the tiny
CPU geometries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Geometry of a UNet2DCondition model. `down_block_types`: "cross"
    (CrossAttnDownBlock2D) or "down"; `up_block_types`: "cross" or "up",
    in forward order as in diffusers. SDXL's `addition_embed_type`
    "text_time" adds the pooled text embed and the sinusoids of the six
    size and crop ids to the time embedding."""

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
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def sd15() -> "UNetConfig":
        return UNetConfig()

    @staticmethod
    def sdxl() -> "UNetConfig":
        return UNetConfig(
            block_out_channels=(320, 640, 1280),
            down_block_types=("down", "cross", "cross"),
            up_block_types=("cross", "cross", "up"),
            transformer_layers_per_block=(0, 2, 10),
            num_attention_heads=(5, 10, 20),
            cross_attention_dim=2048,
            addition_embed_type="text_time",
        )

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

    @staticmethod
    def tiny_xl(cross_attention_dim: int = 32) -> "UNetConfig":
        """CPU-runnable SDXL-topology geometry."""
        return UNetConfig(
            block_out_channels=(32, 64, 64),
            down_block_types=("down", "cross", "cross"),
            up_block_types=("cross", "cross", "up"),
            transformer_layers_per_block=(0, 1, 2),
            num_attention_heads=(2, 2, 2),
            cross_attention_dim=cross_attention_dim,
            norm_num_groups=8,
            addition_embed_type="text_time",
            addition_time_embed_dim=32,
            # the tiny pooled embed (32) and six 32-wide sinusoids; JAX's
            # config says 32 * 6 + 64, which its shape-inferring Dense ignores
            projection_class_embeddings_input_dim=32 + 6 * 32,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text tower: SD1.5 and SDXL's first use the OpenAI ViT-L/14
    text encoder (quick_gelu), SDXL's second OpenCLIP bigG (exact gelu,
    a `text_projection` of the pooled output to `projection_dim`)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    hidden_act: str = "quick_gelu"
    projection_dim: Optional[int] = None
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def sd15() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def sdxl_big_g() -> "CLIPTextConfig":
        return CLIPTextConfig(
            hidden_size=1280,
            intermediate_size=5120,
            num_layers=32,
            num_heads=20,
            hidden_act="gelu",
            projection_dim=1280,
        )

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
    """AutoencoderKL geometry; SD1.5 latents are scaled by 0.18215, SDXL's
    by 0.13025 (the same architecture)."""

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
    def sdxl() -> "VAEConfig":
        return VAEConfig(scaling_factor=0.13025)

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(
            block_out_channels=(16, 32, 32, 32),
            layers_per_block=1,
            norm_num_groups=8,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class BLIPConfig:
    """BLIP image captioner, the frozen concept-matching reward model:
    Salesforce/blip-image-captioning-large, a ViT-L/16 vision encoder at
    384x384 and a BERT-style text decoder with cross-attention (`large`);
    `base` is BLIP-VQA's ViT-B/16 geometry."""

    # vision
    image_size: int = 384
    patch_size: int = 16
    vision_hidden_size: int = 1024
    vision_layers: int = 24
    vision_heads: int = 16
    vision_intermediate_size: int = 4096
    # text decoder (BertLMHeadModel geometry)
    vocab_size: int = 30524
    text_hidden_size: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_intermediate_size: int = 3072
    max_position_embeddings: int = 512
    pad_token_id: int = 0
    bos_token_id: int = 30522  # [DEC]
    sep_token_id: int = 102
    # the published captioning checkpoints leave HF's default: the reward
    # is an unsmoothed cross-entropy
    label_smoothing: float = 0.0
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def large() -> "BLIPConfig":
        return BLIPConfig()

    @staticmethod
    def base() -> "BLIPConfig":
        """The ViT-B/16 vision tower of Salesforce/blip-vqa-base (768 wide,
        12 layers, 12 heads, 3072 inner); the text towers are BERT-base as
        in the captioner. The BLIP-VQA binding scorer uses it: the
        snapshot's 768-wide vision weights do not fit the captioner's
        ViT-L geometry."""
        return BLIPConfig(
            vision_hidden_size=768,
            vision_layers=12,
            vision_heads=12,
            vision_intermediate_size=3072,
        )

    @staticmethod
    def tiny(vocab_size: int = 1000) -> "BLIPConfig":
        return BLIPConfig(
            image_size=64,
            patch_size=16,
            vision_hidden_size=32,
            vision_layers=2,
            vision_heads=2,
            vision_intermediate_size=64,
            vocab_size=vocab_size,
            text_hidden_size=32,
            text_layers=2,
            text_heads=2,
            text_intermediate_size=64,
            bos_token_id=1,
            dtype=torch.float32,
        )
