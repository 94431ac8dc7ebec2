"""Plain PyTorch towers of the CoMat step, in float32, for the benchmark's
reference: the diffusers UNet2DConditionModel (SD1.5 and SDXL topologies),
the AutoencoderKL decoder, the CLIP text towers and the BLIP captioner.

Written from the published architectures (diffusers' and transformers'
module semantics) with their state-dict names, so that one dictionary of
seeded tensors (`reference.weights`) serves both sides. Nothing here
imports the measured program. Departures from the published modules:

- LoRA factors sit beside each UNet attention projection as `lora_a` (in,
  rank) and `lora_b` (rank, out), y = W x + (x A) B, the layout the
  measured program keeps; several named sets of factors can be held
  (`set_lora`), since the discriminator's UNet is the generator's base
  under factors of its own.
- Attention is `F.scaled_dot_product_attention` (exact, no dropout) except
  where the cross-attention probabilities are captured, where the softmax
  is written out.
- No dropout, no caching, batch as given.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------- helpers

def sinusoid(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers get_timestep_embedding, flip_sin_to_cos=True, shift 0."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def attention(q, k, v, heads: int, probs: bool = False):
    """(B, Sq, D) x (B, Sk, D) multi-head attention; with `probs` also the
    (B, heads, Sq, Sk) softmax probabilities."""
    B, Sq, D = q.shape
    Sk = k.shape[1]
    hd = D // heads
    q = q.reshape(B, Sq, heads, hd).transpose(1, 2)
    k = k.reshape(B, Sk, heads, hd).transpose(1, 2)
    v = v.reshape(B, Sk, heads, hd).transpose(1, 2)
    if probs:
        p = torch.softmax((q @ k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
        out = p @ v
    else:
        p = None
        out = F.scaled_dot_product_attention(q, k, v)
    return out.transpose(1, 2).reshape(B, Sq, D), p


class LoRAProj(nn.Linear):
    """nn.Linear with named sets of LoRA factors held outside the module
    (`lora`: a dict name -> (A, B), or None)."""

    def __init__(self, cin, cout, bias):
        super().__init__(cin, cout, bias=bias)
        self.lora: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def forward(self, x):
        y = super().forward(x)
        if self.lora is not None:
            a, b = self.lora
            y = y + (x @ a) @ b
        return y


# ---------------------------------------------------------------- UNet

class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, temb, groups, eps):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout) if temb else None
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, dim, ctx_dim, heads):
        super().__init__()
        self.heads = heads
        self.to_q = LoRAProj(dim, dim, False)
        self.to_k = LoRAProj(ctx_dim, dim, False)
        self.to_v = LoRAProj(ctx_dim, dim, False)
        self.to_out = nn.ModuleList([LoRAProj(dim, dim, True)])

    def forward(self, x, ctx=None, probs=False):
        ctx = x if ctx is None else ctx
        out, p = attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.heads, probs)
        return self.to_out[0](out), p


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(), nn.Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    def __init__(self, dim, ctx_dim, heads):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, ctx_dim, heads)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx, probs):
        x = x + self.attn1(self.norm1(x))[0]
        h, p = self.attn2(self.norm2(x), ctx, probs)
        x = x + h
        return x + self.ff(self.norm3(x)), p


class Transformer2D(nn.Module):
    def __init__(self, dim, ctx_dim, heads, depth, groups):
        super().__init__()
        self.norm = nn.GroupNorm(groups, dim, eps=1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(dim, ctx_dim, heads) for _ in range(depth)])
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x, ctx, probs):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C))
        maps = []
        for blk in self.transformer_blocks:
            h, p = blk(h, ctx, probs)
            maps.append(p)
        h = self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2)
        return x + h, maps


class _Block(nn.Module):
    pass


class UNet(nn.Module):
    """diffusers UNet2DConditionModel for the SD1.5 and SDXL topologies.
    `cfg` holds diffusers' config keys (`block_out_channels`,
    `down_block_types`, `up_block_types`, `layers_per_block`,
    `transformer_layers_per_block`, `attention_heads`, `cross_attention_dim`,
    `norm_num_groups`, `addition_embed_type`, `addition_time_embed_dim`,
    `projection_class_embeddings_input_dim`, `in_channels`, `out_channels`).
    forward(x NCHW, t, ctx, added=None, capture=()) -> (out, {key: [maps]})
    with the cross-attention probabilities of the capture keys
    `{place}_{width}`."""

    def __init__(self, cfg):
        super().__init__()
        ch = list(cfg["block_out_channels"])
        n = len(ch)
        depth = list(cfg["transformer_layers_per_block"])
        heads = list(cfg["attention_heads"])
        groups, ctx = cfg["norm_num_groups"], cfg["cross_attention_dim"]
        lpb = cfg["layers_per_block"]
        temb = ch[0] * 4
        self.sin_dim = ch[0]
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = nn.Linear(ch[0], temb)
        self.time_embedding.linear_2 = nn.Linear(temb, temb)
        self.add_time_dim = None
        if cfg.get("addition_embed_type") == "text_time":
            self.add_time_dim = cfg["addition_time_embed_dim"]
            self.add_embedding = nn.Module()
            self.add_embedding.linear_1 = nn.Linear(
                cfg["projection_class_embeddings_input_dim"], temb)
            self.add_embedding.linear_2 = nn.Linear(temb, temb)
        self.conv_in = nn.Conv2d(cfg["in_channels"], ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cin = ch[0]
        for i, kind in enumerate(cfg["down_block_types"]):
            blk = _Block()
            blk.resnets = nn.ModuleList(
                [ResnetBlock(cin if j == 0 else ch[i], ch[i], temb, groups, 1e-5)
                 for j in range(lpb)])
            blk.attentions = (nn.ModuleList(
                [Transformer2D(ch[i], ctx, heads[i], depth[i], groups) for _ in range(lpb)])
                if kind == "cross" else None)
            blk.downsamplers = None
            if i < n - 1:
                ds = nn.Module()
                ds.conv = nn.Conv2d(ch[i], ch[i], 3, stride=2, padding=1)
                blk.downsamplers = nn.ModuleList([ds])
            self.down_blocks.append(blk)
            cin = ch[i]
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock(ch[-1], ch[-1], temb, groups, 1e-5) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList(
            [Transformer2D(ch[-1], ctx, heads[-1], depth[-1], groups)])
        skips = [ch[0]]
        for i in range(n):
            skips += [ch[i]] * lpb + ([ch[i]] if i < n - 1 else [])
        self.up_blocks = nn.ModuleList()
        cur = ch[-1]
        for i, kind in enumerate(cfg["up_block_types"]):
            c, d, h = ch[n - 1 - i], depth[n - 1 - i], heads[n - 1 - i]
            blk = _Block()
            res = []
            for _ in range(lpb + 1):
                res.append(ResnetBlock(cur + skips.pop(), c, temb, groups, 1e-5))
                cur = c
            blk.resnets = nn.ModuleList(res)
            blk.attentions = (nn.ModuleList(
                [Transformer2D(c, ctx, h, d, groups) for _ in range(lpb + 1)])
                if kind == "cross" else None)
            blk.upsamplers = None
            if i < n - 1:
                us = nn.Module()
                us.conv = nn.Conv2d(c, c, 3, padding=1)
                blk.upsamplers = nn.ModuleList([us])
            self.up_blocks.append(blk)
        self.conv_norm_out = nn.GroupNorm(groups, ch[0], eps=1e-5)
        self.conv_out = nn.Conv2d(ch[0], cfg["out_channels"], 3, padding=1)

    def set_lora(self, factors: Optional[Dict[str, torch.Tensor]]) -> None:
        """Attach the factors `{<proj path>.lora_a|lora_b: tensor}` (None:
        none) to the attention projections."""
        for name, mod in self.named_modules():
            if isinstance(mod, LoRAProj):
                mod.lora = None if factors is None else (
                    factors[name + ".lora_a"], factors[name + ".lora_b"])

    def lora_names(self) -> List[Tuple[str, Tuple[int, int]]]:
        """The projections that take LoRA factors: (path, (in, out))."""
        return [(n, (m.in_features, m.out_features)) for n, m in self.named_modules()
                if isinstance(m, LoRAProj)]

    def forward(self, x, t, ctx, added=None, capture: Sequence[str] = ()):
        B = x.shape[0]
        t = torch.as_tensor(t, device=x.device).reshape(-1).expand(B)
        te = self.time_embedding
        temb = te.linear_2(F.silu(te.linear_1(sinusoid(t, self.sin_dim))))
        if self.add_time_dim is not None:
            ids = sinusoid(added["time_ids"].reshape(-1), self.add_time_dim).reshape(B, -1)
            a = torch.cat([added["text_embeds"], ids], dim=-1)
            ae = self.add_embedding
            temb = temb + ae.linear_2(F.silu(ae.linear_1(a)))
        captured: Dict[str, List[torch.Tensor]] = {}

        def attend(mod, h, place):
            key = f"{place}_{h.shape[-1]}"
            h, maps = mod(h, ctx, key in capture)
            if key in capture:
                captured.setdefault(key, []).extend(maps)
            return h

        h = self.conv_in(x)
        stack = [h]
        for blk in self.down_blocks:
            for j, rn in enumerate(blk.resnets):
                h = rn(h, temb)
                if blk.attentions is not None:
                    h = attend(blk.attentions[j], h, "down")
                stack.append(h)
            if blk.downsamplers is not None:
                h = blk.downsamplers[0].conv(h)
                stack.append(h)
        h = self.mid_block.resnets[0](h, temb)
        h = attend(self.mid_block.attentions[0], h, "mid")
        h = self.mid_block.resnets[1](h, temb)
        for blk in self.up_blocks:
            for j, rn in enumerate(blk.resnets):
                h = rn(torch.cat([h, stack.pop()], dim=1), temb)
                if blk.attentions is not None:
                    h = attend(blk.attentions[j], h, "up")
            if blk.upsamplers is not None:
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h))), captured


# ---------------------------------------------------------------- VAE decoder

class VAEAttention(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        o, _ = attention(self.to_q(h), self.to_k(h), self.to_v(h), 1)
        return x + self.to_out[0](o).reshape(B, H, W, C).permute(0, 3, 1, 2)


class VAEDecoder(nn.Module):
    """post_quant_conv + decoder of diffusers' AutoencoderKL."""

    def __init__(self, cfg):
        super().__init__()
        ch = list(reversed(cfg["block_out_channels"]))
        groups, lat = cfg["norm_num_groups"], cfg["latent_channels"]
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)
        d = nn.Module()
        d.conv_in = nn.Conv2d(lat, ch[0], 3, padding=1)
        d.mid_block = _Block()
        d.mid_block.resnets = nn.ModuleList(
            [ResnetBlock(ch[0], ch[0], 0, groups, 1e-6) for _ in range(2)])
        d.mid_block.attentions = nn.ModuleList([VAEAttention(ch[0], groups)])
        d.up_blocks = nn.ModuleList()
        cur = ch[0]
        for i, c in enumerate(ch):
            blk = _Block()
            blk.resnets = nn.ModuleList(
                [ResnetBlock(cur if j == 0 else c, c, 0, groups, 1e-6)
                 for j in range(cfg["layers_per_block"] + 1)])
            blk.upsamplers = None
            if i < len(ch) - 1:
                us = nn.Module()
                us.conv = nn.Conv2d(c, c, 3, padding=1)
                blk.upsamplers = nn.ModuleList([us])
            d.up_blocks.append(blk)
            cur = c
        d.conv_norm_out = nn.GroupNorm(groups, ch[-1], eps=1e-6)
        d.conv_out = nn.Conv2d(ch[-1], cfg["out_channels"], 3, padding=1)
        self.decoder = d

    def forward(self, z):
        d = self.decoder
        h = d.conv_in(self.post_quant_conv(z))
        h = d.mid_block.resnets[0](h)
        h = d.mid_block.attentions[0](h)
        h = d.mid_block.resnets[1](h)
        for blk in d.up_blocks:
            for rn in blk.resnets:
                h = rn(h)
            if blk.upsamplers is not None:
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2, mode="nearest"))
        return d.conv_out(F.silu(d.conv_norm_out(h)))


# ---------------------------------------------------------------- CLIP text

def _act(name):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    return F.gelu


class CLIPLayer(nn.Module):
    def __init__(self, D, inner, heads, act):
        super().__init__()
        self.heads, self.act = heads, _act(act)
        self.self_attn = nn.Module()
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, p, nn.Linear(D, D))
        self.layer_norm1 = nn.LayerNorm(D)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(D, inner)
        self.mlp.fc2 = nn.Linear(inner, D)
        self.layer_norm2 = nn.LayerNorm(D)

    def forward(self, x):
        B, S, D = x.shape
        a = self.self_attn
        h = self.layer_norm1(x)
        hd = D // self.heads

        def split(t):
            return t.reshape(B, S, self.heads, hd).transpose(1, 2)

        o = F.scaled_dot_product_attention(split(a.q_proj(h)), split(a.k_proj(h)),
                                           split(a.v_proj(h)), is_causal=True)
        x = x + a.out_proj(o.transpose(1, 2).reshape(B, S, D))
        return x + self.mlp.fc2(self.act(self.mlp.fc1(self.layer_norm2(x))))


class CLIPText(nn.Module):
    """transformers' CLIPTextModel (with `projection_dim`, the bigG tower's
    CLIPTextModelWithProjection). forward(ids, skip=0, eos=None) ->
    (hidden states `skip` layers before the last (the final layer norm
    only at skip 0), pooled: the final-normed state at `eos` (S - 1 when
    None), projected where the tower projects)."""

    def __init__(self, cfg):
        super().__init__()
        D = cfg["hidden_size"]
        tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], D)
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], D)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList(
            [CLIPLayer(D, cfg["intermediate_size"], cfg["num_attention_heads"],
                       cfg["hidden_act"]) for _ in range(cfg["num_hidden_layers"])])
        tm.final_layer_norm = nn.LayerNorm(D)
        self.text_model = tm
        self.text_projection = (nn.Linear(D, cfg["projection_dim"], bias=False)
                                if cfg.get("projection_dim") else None)

    def forward(self, ids, skip: int = 0, eos=None):
        tm = self.text_model
        S = ids.shape[1]
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding.weight[:S]
        layers = tm.encoder.layers
        hidden = None
        for i, layer in enumerate(layers):
            x = layer(x)
            if i == len(layers) - 1 - skip:
                hidden = x
        final = tm.final_layer_norm(x)
        if skip == 0:
            hidden = final
        B = ids.shape[0]
        eos = torch.full((B,), S - 1, device=ids.device) if eos is None else eos.long()
        pooled = final[torch.arange(B, device=ids.device), eos]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return hidden, pooled


# ---------------------------------------------------------------- BLIP

class BlipVisionLayer(nn.Module):
    def __init__(self, D, inner, heads):
        super().__init__()
        self.heads = heads
        self.layer_norm1 = nn.LayerNorm(D)
        self.self_attn = nn.Module()
        self.self_attn.qkv = nn.Linear(D, 3 * D)
        self.self_attn.projection = nn.Linear(D, D)
        self.layer_norm2 = nn.LayerNorm(D)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(D, inner)
        self.mlp.fc2 = nn.Linear(inner, D)

    def forward(self, x):
        q, k, v = self.self_attn.qkv(self.layer_norm1(x)).chunk(3, dim=-1)
        x = x + self.self_attn.projection(attention(q, k, v, self.heads)[0])
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.layer_norm2(x))))


def _bert_attention(D, kv):
    m = nn.Module()
    s = nn.Module()
    s.query, s.key, s.value = nn.Linear(D, D), nn.Linear(kv, D), nn.Linear(kv, D)
    setattr(m, "self", s)
    m.output = nn.Module()
    m.output.dense = nn.Linear(D, D)
    m.output.LayerNorm = nn.LayerNorm(D, eps=1e-12)
    return m


class BlipTextLayer(nn.Module):
    def __init__(self, D, kv, inner, heads):
        super().__init__()
        self.heads = heads
        self.attention = _bert_attention(D, D)
        self.crossattention = _bert_attention(D, kv)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(D, inner)
        self.output = nn.Module()
        self.output.dense = nn.Linear(inner, D)
        self.output.LayerNorm = nn.LayerNorm(D, eps=1e-12)

    def _attend(self, m, x, kv, mask):
        s = getattr(m, "self")
        B, Sq, D = x.shape
        Sk = kv.shape[1]
        hd = D // self.heads

        def split(t, S):
            return t.reshape(B, S, self.heads, hd).transpose(1, 2)

        o = F.scaled_dot_product_attention(split(s.query(x), Sq), split(s.key(kv), Sk),
                                           split(s.value(kv), Sk), attn_mask=mask)
        o = o.transpose(1, 2).reshape(B, Sq, D)
        return m.output.LayerNorm(x + m.output.dense(o))

    def forward(self, x, mask, enc):
        x = self._attend(self.attention, x, x, mask)
        x = self._attend(self.crossattention, x, enc, None)
        return self.output.LayerNorm(x + self.output.dense(F.gelu(self.intermediate.dense(x))))


class BLIPCaptioner(nn.Module):
    """transformers' BlipForConditionalGeneration: the ViT vision model and
    the BERT text decoder with its LM head; `caption_loss` is its shifted
    cross-entropy, mean over the labels that are not -100."""

    def __init__(self, cfg):
        super().__init__()
        Dv, Dt = cfg["vision_hidden_size"], cfg["text_hidden_size"]
        self.vheads = cfg["vision_heads"]
        vm = nn.Module()
        vm.embeddings = nn.Module()
        p = cfg["patch_size"]
        vm.embeddings.patch_embedding = nn.Conv2d(3, Dv, p, stride=p)
        vm.embeddings.class_embedding = nn.Parameter(torch.zeros(1, 1, Dv))
        npos = (cfg["image_size"] // p) ** 2 + 1
        vm.embeddings.position_embedding = nn.Parameter(torch.zeros(1, npos, Dv))
        vm.encoder = nn.Module()
        vm.encoder.layers = nn.ModuleList(
            [BlipVisionLayer(Dv, cfg["vision_intermediate_size"], cfg["vision_heads"])
             for _ in range(cfg["vision_layers"])])
        vm.post_layernorm = nn.LayerNorm(Dv)
        self.vision_model = vm
        td = nn.Module()
        td.bert = nn.Module()
        e = td.bert.embeddings = nn.Module()
        e.word_embeddings = nn.Embedding(cfg["vocab_size"], Dt)
        e.position_embeddings = nn.Embedding(cfg["max_position_embeddings"], Dt)
        e.LayerNorm = nn.LayerNorm(Dt, eps=1e-12)
        td.bert.encoder = nn.Module()
        td.bert.encoder.layer = nn.ModuleList(
            [BlipTextLayer(Dt, Dv, cfg["text_intermediate_size"], cfg["text_heads"])
             for _ in range(cfg["text_layers"])])
        td.cls = nn.Module()
        pr = td.cls.predictions = nn.Module()
        pr.transform = nn.Module()
        pr.transform.dense = nn.Linear(Dt, Dt)
        pr.transform.LayerNorm = nn.LayerNorm(Dt, eps=1e-12)
        pr.decoder = nn.Linear(Dt, cfg["vocab_size"], bias=False)
        pr.bias = nn.Parameter(torch.zeros(cfg["vocab_size"]))
        self.text_decoder = td

    def caption_loss(self, pixels, ids, mask, labels):
        """pixels (B, 3, H, W) normalised; ids, mask, labels (B, S)."""
        vm = self.vision_model
        x = vm.embeddings.patch_embedding(pixels).flatten(2).transpose(1, 2)
        x = torch.cat([vm.embeddings.class_embedding.expand(x.shape[0], -1, -1), x], dim=1)
        x = x + vm.embeddings.position_embedding[:, :x.shape[1]]
        for layer in vm.encoder.layers:
            x = layer(x)
        enc = vm.post_layernorm(x)
        td = self.text_decoder
        e = td.bert.embeddings
        S = ids.shape[1]
        h = e.LayerNorm(e.word_embeddings(ids) + e.position_embeddings.weight[:S])
        causal = torch.ones(S, S, dtype=torch.bool, device=ids.device).tril()
        m = causal[None, None] & mask.bool()[:, None, None, :]
        for layer in td.bert.encoder.layer:
            h = layer(h, m, enc)
        pr = td.cls.predictions
        h = pr.transform.LayerNorm(F.gelu(pr.transform.dense(h)))
        logits = pr.decoder(h) + pr.bias
        return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               labels[:, 1:].reshape(-1).long(), ignore_index=-100)
