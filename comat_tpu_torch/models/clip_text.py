"""CLIP text encoders in PyTorch: the ViT-L/14 text tower (SD1.5, SDXL's
first) and OpenCLIP bigG (SDXL's second).

Port of comat_tpu/models/clip_text.py: causal attention with a -1e30
mask and an fp32 softmax, quick_gelu or exact gelu, final LayerNorm, and
the pooled output taken at each row's EOS position from the final
LayerNorm'd states, projected by `text_projection` (fp32) where the
config has a `projection_dim`. `output_hidden_state_skip=1` returns the
input to the last layer, without the final LayerNorm, as SDXL reads both
towers (transformers' `hidden_states[-2]`). Parameter names follow
transformers' CLIPTextModel(WithProjection) (`text_model.embeddings...`,
`text_model.encoder.layers.{i}...`, `text_model.final_layer_norm`,
`text_projection`). With `lora_rank > 0` (--train_text_encoder_lora) the
attention projections `q_proj`, `k_proj`, `v_proj` and `out_proj` carry a
LoRA branch (`models.lora.LoRALinear`: the projection under `.base`, the
fp32 factors `lora_a` / `lora_b`), as JAX's `LoRADense` does; at rank 0
they are plain `nn.Linear`s under transformers' names.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from comat_tpu_torch.config import CLIPTextConfig
from comat_tpu_torch.models.lora import LoRALinear


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None, lora_rank: int = 0):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        D = cfg.hidden_size
        self.num_heads = cfg.num_heads

        def proj():
            if lora_rank > 0:
                return LoRALinear(D, D, lora_rank=lora_rank, **kw)
            return nn.Linear(D, D, **kw)

        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            proj(), proj(), proj(), proj())

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        hd = D // self.num_heads

        def split(a):
            return a.reshape(B, S, self.num_heads, hd).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (hd ** 0.5)
        logits = torch.where(causal, logits, torch.full_like(logits, -1e30))
        probs = torch.softmax(logits, dim=-1)
        out = torch.matmul(probs.to(v.dtype), v).to(x.dtype)
        return self.out_proj(out.transpose(1, 2).reshape(B, S, D))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        # "gelu" is the exact (erf) GELU, without the tanh approximation
        self.act = quick_gelu if cfg.hidden_act == "quick_gelu" else F.gelu
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None, lora_rank: int = 0):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5, **kw)
        self.self_attn = CLIPAttention(cfg, device, lora_rank)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5, **kw)
        self.mlp = CLIPMLP(cfg, device)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.token_embedding = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype, device=device
        )
        # fp32 master table, added in the compute dtype (as in JAX)
        self.position_embedding = nn.Embedding(
            cfg.max_length, cfg.hidden_size, dtype=torch.float32, device=device
        )

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tok = self.token_embedding(input_ids)
        pos = self.position_embedding.weight[: input_ids.shape[1]]
        return tok + pos.to(tok.dtype)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None, lora_rank: int = 0):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg, device, lora_rank) for _ in range(cfg.num_layers)]
        )


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None, lora_rank: int = 0):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg, device)
        self.encoder = CLIPEncoder(cfg, device, lora_rank)
        self.final_layer_norm = nn.LayerNorm(
            cfg.hidden_size, eps=1e-5, dtype=cfg.dtype, device=device
        )


class CLIPTextEncoder(nn.Module):
    """Returns (hidden_states (B, S, D), pooled (B, D or projection_dim)):
    the final LayerNorm'd states (or, with `output_hidden_state_skip=n`,
    the input to the n-th layer from the end, without the final
    LayerNorm), and the final states at each row's EOS position (default
    S - 1), through `text_projection` where the config has one."""

    def __init__(self, cfg: CLIPTextConfig, device=None, lora_rank: int = 0):
        super().__init__()
        self.cfg = cfg
        self.lora_rank = lora_rank
        self.text_model = CLIPTextTransformer(cfg, device, lora_rank)
        self.text_projection = None
        if cfg.projection_dim is not None:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim,
                                             bias=False, dtype=torch.float32,
                                             device=device)

    def forward(
        self, input_ids: torch.Tensor,
        eos_positions: Optional[torch.Tensor] = None,
        output_hidden_state_skip: int = 0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        tm = self.text_model
        B, S = input_ids.shape
        x = tm.embeddings(input_ids)
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        n = len(tm.encoder.layers)
        penult = None
        for i, layer in enumerate(tm.encoder.layers):
            if output_hidden_state_skip and i == n - output_hidden_state_skip:
                penult = x
            x = layer(x, causal)
        final = tm.final_layer_norm(x)
        if eos_positions is None:
            eos_positions = torch.full((B,), S - 1, device=x.device)
        pooled = final[torch.arange(B, device=x.device), eos_positions.long()]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled.float()).to(final.dtype)
        return (final if output_hidden_state_skip == 0 else penult), pooled
