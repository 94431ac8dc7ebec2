"""UNet2DCondition (SD1.5 and SDXL topologies) in PyTorch.

Port of comat_tpu/models/unet.py: timestep embedding, SDXL's added
embedding (`add_embedding` over the pooled text embed and the sinusoids
of the six size and crop ids, `forward(added_cond=)`), ResnetBlock,
Attention with LoRA q/k/v/out, GEGLU FeedForward, TransformerBlock,
Transformer2D, Downsample/Upsample and the UNet itself. Parameter names
follow diffusers' UNet2DConditionModel, except that the attention
projections hold their weight under `.base` (see models/lora.py) and the
transformers' proj_in/proj_out are linear layers (SDXL's are; SD1.5's 1x1
convs are the same product). Blocks follow the config's per-level depth
and heads; a level with 0 transformer layers has none. Activations run NCHW in
channels_last memory; the public layout is the JAX one, latents
(B, h, w, 4). `forward(..., remat=)` checkpoints the resnet and
transformer blocks that JAX's `_remat_at` picks (models/remat.py). The
layers JAX builds as `QConv` / `QDense` / `QDenseGeneral` are `QConv2d` /
`QLinear` (models/quant.py): plain while no int8 weight set is installed.

Capture mode (`forward(..., capture=True)`) also returns the fp32
cross-attention probabilities (B, heads, HW, 77) of every transformer
block, keyed `{place}_{res}` (place down, mid or up; res the block's
spatial size) and filtered by `capture_layers`, as the JAX UNet's
`want`/`record` do. Only cross-attention (`attn2`) is captured; it takes
the plain attention path, and the self-attention keeps the flash
dispatch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from comat_tpu_torch import trace
from comat_tpu_torch.config import UNetConfig
from comat_tpu_torch.models import remat as rm
from comat_tpu_torch.models.lora import LoRALinear
from comat_tpu_torch.models.quant import QConv2d, QLinear
from comat_tpu_torch.ops.attention import multi_head_attention


def timestep_embedding(
    timesteps: torch.Tensor, dim: int, max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal embedding in fp32, diffusers `get_timestep_embedding`
    with flip_sin_to_cos=True and freq_shift=0."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.float()[:, None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, embed_dim: int, dtype, device=None):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim, dtype=dtype, device=device)
        self.linear_2 = nn.Linear(embed_dim, embed_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: int, groups: int,
                 dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-5, **kw)
        self.conv1 = QConv2d(cin, cout, 3, padding=1, **kw)
        self.time_emb_proj = nn.Linear(temb_dim, cout, **kw)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-5, **kw)
        self.conv2 = QConv2d(cout, cout, 3, padding=1, **kw)
        self.conv_shortcut = (
            QConv2d(cin, cout, 1, **kw) if cin != cout else None
        )

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Self- or cross-attention with LoRA q/k/v/out."""

    def __init__(self, dim: int, ctx_dim: int, heads: int, lora_rank: int,
                 dtype, device=None):
        super().__init__()
        kw = dict(lora_rank=lora_rank, dtype=dtype, device=device)
        self.heads = heads
        self.to_q = LoRALinear(dim, dim, bias=False, **kw)
        self.to_k = LoRALinear(ctx_dim, dim, bias=False, **kw)
        self.to_v = LoRALinear(ctx_dim, dim, bias=False, **kw)
        self.to_out = nn.ModuleList([LoRALinear(dim, dim, bias=True, **kw)])

    def forward(self, x: torch.Tensor, context=None,
                sink: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """`sink`: a list that receives the fp32 probabilities (capture)."""
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        if sink is None:
            out = multi_head_attention(q, k, v, self.heads)
        else:
            out, probs = multi_head_attention(q, k, v, self.heads,
                                              capture_probs=True)
            sink.append(probs)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    """Fused value|gate projection: columns [values, gates]."""

    def __init__(self, dim: int, inner: int, dtype, device=None):
        super().__init__()
        self.proj = QLinear(dim, 2 * inner, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, dtype, device=None):
        super().__init__()
        self.net = nn.ModuleList([
            GEGLU(dim, 4 * dim, dtype, device),
            nn.Identity(),
            QLinear(4 * dim, dim, dtype=dtype, device=device),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, ctx_dim: int, heads: int, lora_rank: int,
                 dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.attn1 = Attention(dim, dim, heads, lora_rank, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.attn2 = Attention(dim, ctx_dim, heads, lora_rank, **kw)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.ff = FeedForward(dim, **kw)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                sink: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context, sink)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """GroupNorm -> proj_in -> transformer blocks -> proj_out + residual."""

    def __init__(self, dim: int, ctx_dim: int, heads: int, layers: int,
                 groups: int, lora_rank: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm = nn.GroupNorm(groups, dim, eps=1e-6, **kw)
        self.proj_in = QLinear(dim, dim, **kw)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(dim, ctx_dim, heads, lora_rank, **kw)
            for _ in range(layers)
        ])
        self.proj_out = QLinear(dim, dim, **kw)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                sink: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """`sink` receives each block's cross-attention probabilities."""
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.proj_in(h)
        for block in self.transformer_blocks:
            h = block(h, context, sink)
        h = self.proj_out(h)
        return h.reshape(B, H, W, C).permute(0, 3, 1, 2) + x


class Downsample2D(nn.Module):
    def __init__(self, ch: int, dtype, device=None):
        super().__init__()
        self.conv = QConv2d(ch, ch, 3, stride=2, padding=1, dtype=dtype,
                            device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch: int, dtype, device=None):
        super().__init__()
        self.conv = QConv2d(ch, ch, 3, padding=1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """A down or up block: resnets, optional transformers, optional
    resampler (diffusers names: resnets, attentions, down/upsamplers)."""

    def __init__(self, resnets, attentions, resampler_name="", resampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        self._resampler_name = resampler_name if resampler is not None else None
        if resampler is not None:
            setattr(self, resampler_name, nn.ModuleList([resampler]))

    def resample(self, h: torch.Tensor) -> torch.Tensor:
        if self._resampler_name is None:
            return h
        return getattr(self, self._resampler_name)[0](h)

    @property
    def has_resampler(self) -> bool:
        return self._resampler_name is not None


class UNet2DConditionModel(nn.Module):
    """The denoiser: eps = unet(latents (B, h, w, 4), t, context)."""

    def __init__(self, cfg: UNetConfig, lora_rank: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        kw = dict(dtype=dt, device=device)
        ch0 = cfg.block_out_channels[0]
        temb_dim = ch0 * 4
        groups = cfg.norm_num_groups
        ctx_dim = cfg.cross_attention_dim
        n = len(cfg.block_out_channels)

        self.time_embedding = TimestepEmbedding(ch0, temb_dim, **kw)
        self.add_embedding = None
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb_dim, **kw)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1, **kw)

        self.down_blocks = nn.ModuleList()
        skips = [ch0]
        cin = ch0
        for i, (btype, ch) in enumerate(
            zip(cfg.down_block_types, cfg.block_out_channels)
        ):
            resnets, attns = [], []
            for j in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(
                    cin if j == 0 else ch, ch, temb_dim, groups, **kw
                ))
                if btype == "cross":
                    attns.append(Transformer2DModel(
                        ch, ctx_dim, cfg.num_attention_heads[i],
                        cfg.transformer_layers_per_block[i], groups,
                        lora_rank, **kw,
                    ))
                skips.append(ch)
            down = Downsample2D(ch, **kw) if i < n - 1 else None
            if down is not None:
                skips.append(ch)
            self.down_blocks.append(_Block(resnets, attns, "downsamplers", down))
            cin = ch

        mid_ch = cfg.block_out_channels[-1]
        self.mid_block = _Block(
            [ResnetBlock2D(mid_ch, mid_ch, temb_dim, groups, **kw),
             ResnetBlock2D(mid_ch, mid_ch, temb_dim, groups, **kw)],
            [Transformer2DModel(
                mid_ch, ctx_dim, cfg.num_attention_heads[-1],
                max(cfg.transformer_layers_per_block[-1], 1), groups,
                lora_rank, **kw,
            )],
        )

        rev_ch = tuple(reversed(cfg.block_out_channels))
        rev_heads = tuple(reversed(cfg.num_attention_heads))
        rev_tx = tuple(reversed(cfg.transformer_layers_per_block))
        self.up_blocks = nn.ModuleList()
        cur = mid_ch
        for i, btype in enumerate(cfg.up_block_types):
            ch = rev_ch[i]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(
                    cur + skips.pop(), ch, temb_dim, groups, **kw
                ))
                cur = ch
                if btype == "cross":
                    attns.append(Transformer2DModel(
                        ch, ctx_dim, rev_heads[i], rev_tx[i], groups,
                        lora_rank, **kw,
                    ))
            up = Upsample2D(ch, **kw) if i < n - 1 else None
            self.up_blocks.append(_Block(resnets, attns, "upsamplers", up))

        self.conv_norm_out = nn.GroupNorm(groups, ch0, eps=1e-5, **kw)
        # the output conv runs in fp32, as in the JAX module
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1,
                                  dtype=torch.float32, device=device)

    def forward(
        self,
        sample: torch.Tensor,
        timesteps: Union[int, torch.Tensor],
        encoder_hidden_states: torch.Tensor,
        added_cond: Optional[Dict[str, torch.Tensor]] = None,
        capture: bool = False,
        capture_layers: Sequence[str] = (),
        remat: rm.Remat = False,
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, List[torch.Tensor]]]]:
        """eps (B, h, w, 4); with `capture`, (eps, {key: [probs, ...]}),
        the keys those of `capture_layers` (every key when it is empty).
        `timesteps`: an int, or a tensor of one or B timesteps; a tensor
        already on the sample's device is read there, anything else is
        uploaded (the sync "unet.timesteps").
        `added_cond` (SDXL, required there): {"text_embeds" (B, D),
        "time_ids" (B, 6)}.
        `remat`: True checkpoints every resnet and transformer block, an
        int R those at spatial resolution >= R; a captured block returns
        its maps through the checkpoint."""
        dt = self.cfg.dtype
        B = sample.shape[0]
        if isinstance(timesteps, torch.Tensor) and timesteps.device == sample.device:
            t = timesteps
        else:
            with trace.sync("unet.timesteps"):
                t = torch.as_tensor(timesteps, device=sample.device)
        if t.dim() == 0:
            t = t.expand(B)
        temb = self.time_embedding(
            timestep_embedding(t, self.cfg.block_out_channels[0]).to(dt)
        )
        if self.add_embedding is not None:
            if added_cond is None:
                raise ValueError("an SDXL UNet needs added_cond")
            t_emb = timestep_embedding(
                added_cond["time_ids"].reshape(-1),
                self.cfg.addition_time_embed_dim).reshape(B, -1)
            add = torch.cat([added_cond["text_embeds"].float(), t_emb], dim=-1)
            temb = temb + self.add_embedding(add.to(dt))
        ctx = encoder_hidden_states.to(dt)
        h = self.conv_in(sample.to(dt).permute(0, 3, 1, 2))
        captured: Dict[str, List[torch.Tensor]] = {}

        def res(resnet, h):
            return rm.call(resnet, h, temb, remat=rm.remat_at(remat, h.shape[2]))

        def with_maps(tx):
            def run(h, ctx):
                sink: List[torch.Tensor] = []
                return (tx(h, ctx, sink), *sink)
            return run

        def attend(tx, h, place):
            key = f"{place}_{h.shape[2]}"
            at = rm.remat_at(remat, h.shape[2])
            if not capture or (capture_layers and key not in capture_layers):
                return rm.call(tx, h, ctx, remat=at)
            out, *maps = rm.call(with_maps(tx), h, ctx, remat=at)
            captured.setdefault(key, []).extend(maps)
            return out

        stack = [h]
        for block in self.down_blocks:
            for j, resnet in enumerate(block.resnets):
                h = res(resnet, h)
                if block.attentions is not None:
                    h = attend(block.attentions[j], h, "down")
                stack.append(h)
            if block.has_resampler:
                h = block.resample(h)
                stack.append(h)

        h = res(self.mid_block.resnets[0], h)
        h = attend(self.mid_block.attentions[0], h, "mid")
        h = res(self.mid_block.resnets[1], h)

        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                h = res(resnet, torch.cat([h, stack.pop()], dim=1))
                if block.attentions is not None:
                    h = attend(block.attentions[j], h, "up")
            h = block.resample(h)

        h = F.silu(self.conv_norm_out(h))
        out = self.conv_out(h.float()).permute(0, 2, 3, 1)
        return (out, captured) if capture else out
