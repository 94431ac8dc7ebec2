"""Operations and bytes of the CoMat step, counted from the configuration
and the recipe alone, never from the measured program's launches, so that
a change to a kernel cannot move them.

A multiply-add is two operations. GEMMs and convolutions count their
products; norms, activations and the scheduler's elementwise steps are not
counted. `unet_fwd` and the others return {"lin": ..., "attn": ...}: the
products of weights (linear layers, convolutions, LoRA branches) and the
attention cores (Q K^T and P V). A frozen tower's backward computes the
gradient of its input only: its linear part costs one forward's products
(dX = dY W^T), its attention cores two (dP, dV, dQ, dK).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12,
              "int8": 1979e12}
PEAK_BYTES = 3.35e12


def conv(B, H, W, cin, cout, k=3) -> float:
    """A k x k convolution with H x W outputs."""
    return 2.0 * B * H * W * k * k * cin * cout


def linear(M, cin, cout) -> float:
    return 2.0 * M * cin * cout


def attn_core(B, Sq, Skv, D) -> float:
    """Q K^T and P V over all heads, D the heads' total width."""
    return 4.0 * B * Sq * Skv * D


def _add(acc: Dict[str, float], lin=0.0, attn=0.0) -> None:
    acc["lin"] += lin
    acc["attn"] += attn


def _resnet(acc, B, H, W, cin, cout, temb):
    _add(acc, conv(B, H, W, cin, cout) + conv(B, H, W, cout, cout)
         + (conv(B, H, W, cin, cout, 1) if cin != cout else 0.0)
         + (linear(B, temb, cout) if temb else 0.0))


def _proj(M, cin, cout, rank) -> float:
    """A projection with its LoRA branch (x A) B of `rank`."""
    return linear(M, cin, cout) + (linear(M, cin, rank) + linear(M, rank, cout) if rank else 0.0)


def _transformer(acc, B, N, C, depth, ctx, L, rank):
    _add(acc, linear(B * N, C, C) * 2)                       # proj_in, proj_out
    for _ in range(depth):
        M = B * N
        _add(acc, 4 * _proj(M, C, C, rank), attn_core(B, N, N, C))        # attn1
        _add(acc, 2 * _proj(M, C, C, rank) + 2 * _proj(B * L, ctx, C, rank),
             attn_core(B, N, L, C))                                      # attn2
        _add(acc, linear(M, C, 8 * C) + linear(M, 4 * C, C))             # GEGLU
    return acc


def unet_layers(cfg: dict, latent: int) -> List[Tuple[str, int, int, int, int]]:
    """The UNet's transformers in order: (place, resolution, channels,
    depth, heads)."""
    ch, depth, heads = (cfg["block_out_channels"], cfg["transformer_layers_per_block"],
                        cfg["attention_heads"])
    n, lpb, out, res = len(ch), cfg["layers_per_block"], [], latent
    for i, kind in enumerate(cfg["down_block_types"]):
        if kind == "cross":
            out += [("down", res, ch[i], depth[i], heads[i])] * lpb
        if i < n - 1:
            res //= 2
    out.append(("mid", res, ch[-1], depth[-1], heads[-1]))
    for i, kind in enumerate(cfg["up_block_types"]):
        j = n - 1 - i
        if kind == "cross":
            out += [("up", res, ch[j], depth[j], heads[j])] * (lpb + 1)
        if i < n - 1:
            res *= 2
    return out


def unet_fwd(cfg: dict, B: int, latent: int, L: int = 77, rank: int = 0) -> Dict[str, float]:
    """One UNet forward over B latents of latent x latent, a context of L
    tokens, LoRA branches of `rank` on the attention projections."""
    acc = {"lin": 0.0, "attn": 0.0}
    ch, n, lpb = cfg["block_out_channels"], len(cfg["block_out_channels"]), cfg["layers_per_block"]
    temb, ctx = ch[0] * 4, cfg["cross_attention_dim"]
    _add(acc, linear(B, ch[0], temb) + linear(B, temb, temb))
    if cfg.get("addition_embed_type") == "text_time":
        _add(acc, linear(B, cfg["projection_class_embeddings_input_dim"], temb)
             + linear(B, temb, temb))
    res = latent
    _add(acc, conv(B, res, res, cfg["in_channels"], ch[0]))
    skips, cin = [ch[0]], ch[0]
    tf = {(p, r): (c, d) for p, r, c, d, _ in unet_layers(cfg, latent)}
    for i, kind in enumerate(cfg["down_block_types"]):
        for j in range(lpb):
            _resnet(acc, B, res, res, cin if j == 0 else ch[i], ch[i], temb)
            if kind == "cross":
                _transformer(acc, B, res * res, ch[i], tf[("down", res)][1], ctx, L, rank)
            skips.append(ch[i])
        cin = ch[i]
        if i < n - 1:
            res //= 2
            _add(acc, conv(B, res, res, ch[i], ch[i]))
            skips.append(ch[i])
    for _ in range(2):
        _resnet(acc, B, res, res, ch[-1], ch[-1], temb)
    _transformer(acc, B, res * res, ch[-1], tf[("mid", res)][1], ctx, L, rank)
    cur = ch[-1]
    for i, kind in enumerate(cfg["up_block_types"]):
        c = ch[n - 1 - i]
        for _ in range(lpb + 1):
            _resnet(acc, B, res, res, cur + skips.pop(), c, temb)
            cur = c
            if kind == "cross":
                _transformer(acc, B, res * res, c, tf[("up", res)][1], ctx, L, rank)
        if i < n - 1:
            res *= 2
            _add(acc, conv(B, res, res, c, c))
    _add(acc, conv(B, res, res, ch[0], cfg["out_channels"]))
    return acc


def vae_decoder_fwd(cfg: dict, B: int, latent: int) -> Dict[str, float]:
    acc = {"lin": 0.0, "attn": 0.0}
    ch = list(reversed(cfg["block_out_channels"]))
    lat, res = cfg["latent_channels"], latent
    _add(acc, conv(B, res, res, lat, lat, 1) + conv(B, res, res, lat, ch[0]))
    for _ in range(2):
        _resnet(acc, B, res, res, ch[0], ch[0], 0)
    N = res * res
    _add(acc, 4 * linear(B * N, ch[0], ch[0]), attn_core(B, N, N, ch[0]))
    cur = ch[0]
    for i, c in enumerate(ch):
        for j in range(cfg["layers_per_block"] + 1):
            _resnet(acc, B, res, res, cur if j == 0 else c, c, 0)
        cur = c
        if i < len(ch) - 1:
            res *= 2
            _add(acc, conv(B, res, res, c, c))
    _add(acc, conv(B, res, res, ch[-1], cfg["out_channels"]))
    return acc


def clip_fwd(cfg: dict, B: int, S: int = 77) -> Dict[str, float]:
    D, inner, M = cfg["hidden_size"], cfg["intermediate_size"], B * S
    per = 4 * linear(M, D, D) + 2 * linear(M, D, inner)
    acc = {"lin": cfg["num_hidden_layers"] * per + (
        linear(B, D, cfg["projection_dim"]) if cfg.get("projection_dim") else 0.0),
        "attn": cfg["num_hidden_layers"] * attn_core(B, S, S, D)}
    return acc


def blip_fwd(cfg: dict, B: int, S: int) -> Dict[str, float]:
    """The captioner over B images and captions of S tokens."""
    Dv, Dt, p = cfg["vision_hidden_size"], cfg["text_hidden_size"], cfg["patch_size"]
    grid = cfg["image_size"] // p
    N = grid * grid + 1
    acc = {"lin": 0.0, "attn": 0.0}
    _add(acc, conv(B, grid, grid, 3, Dv, p))
    for _ in range(cfg["vision_layers"]):
        _add(acc, linear(B * N, Dv, 3 * Dv) + linear(B * N, Dv, Dv)
             + 2 * linear(B * N, Dv, cfg["vision_intermediate_size"]),
             attn_core(B, N, N, Dv))
    M = B * S
    for _ in range(cfg["text_layers"]):
        _add(acc, 4 * linear(M, Dt, Dt) + 2 * linear(M, Dt, Dt) + 2 * linear(B * N, Dv, Dt)
             + 2 * linear(M, Dt, cfg["text_intermediate_size"]),
             attn_core(B, S, S, Dt) + attn_core(B, S, N, Dt))
    _add(acc, linear(M, Dt, Dt) + linear(M, Dt, cfg["vocab_size"]))
    return acc


def frozen_bwd(f: Dict[str, float]) -> float:
    """The products of a frozen tower's input gradient."""
    return f["lin"] + 2 * f["attn"]


def total(f: Dict[str, float]) -> float:
    return f["lin"] + f["attn"]


def train_step_flops(cfg: dict, tc: dict, batch: int) -> Dict[str, float]:
    """Model operations of one CoMat step, by part: the text encodings,
    pass 1's guided UNet calls, the K replayed guided calls with their
    backward, the captures with theirs, the VAE decode and backward, BLIP
    forward and backward, D on the G side (forward, input gradient) and in
    its update (forward over 2B, backward). Recomputation under remat and
    the presample's extra decode are not counted, nor Grounded-SAM."""
    B, lat = batch, tc["resolution"] // 8
    rank, K, S = tc["lora_rank"], tc["K"], tc["total_step"]
    A = min(tc["attrcon_train_steps"], K)
    text = 2 * total(clip_fwd(cfg["text"], B))
    if cfg.get("text2"):
        text += 2 * total(clip_fwd(cfg["text2"], B))
    g2 = unet_fwd(cfg["unet"], 2 * B, lat, rank=rank)
    g1 = unet_fwd(cfg["unet"], B, lat, rank=rank)
    d_cfg = cfg.get("d_unet") or cfg["unet"]
    d1, d2 = unet_fwd(d_cfg, B, lat, rank=rank), unet_fwd(d_cfg, 2 * B, lat, rank=rank)
    vae = vae_decoder_fwd(cfg["vae"], B, lat)
    blip = blip_fwd(cfg["blip"], B, cfg["blip"]["caption_tokens"])
    return {
        "text": text,
        "pass1": S * total(g2),
        "replay": K * (total(g2) + frozen_bwd(g2)),
        "capture": A * (total(g1) + frozen_bwd(g1)),
        "decode": total(vae) + frozen_bwd(vae),
        "reward": total(blip) + frozen_bwd(blip),
        "gan_g": total(d1) + frozen_bwd(d1),
        "d_update": total(d2) + frozen_bwd(d2),
    }


# ---------------------------------------------------------------- attention

def flash_calls(cfg: dict, tc: dict, batch: int) -> List[Tuple[str, int, int, int, int]]:
    """The self-attention over image tokens of one step, as
    (pass, batch, heads, tokens, head width) for the forward ("fwd") and
    the two backward passes ("dq", "dkv"): the UNet's self-attention in
    pass 1, the replay and the captures, and the VAE's mid-block."""
    B, lat = batch, tc["resolution"] // 8
    K, S = tc["K"], tc["total_step"]
    A = min(tc["attrcon_train_steps"], K)
    layers = unet_layers(cfg["unet"], lat)
    out = []

    def unet(b, n, bwd):
        for _, res, c, depth, heads in layers:
            shape = (b, heads, res * res, c // heads)
            out.extend([("fwd", *shape)] * (n * depth))
            if bwd:
                out.extend([("dq", *shape)] * (n * depth) + [("dkv", *shape)] * (n * depth))

    unet(2 * B, S, False)
    unet(2 * B, K, True)
    unet(B, A, True)
    vres = lat
    vshape = (B, 1, vres * vres, cfg["vae"]["block_out_channels"][-1])
    out += [("fwd", *vshape), ("dq", *vshape), ("dkv", *vshape)]
    return out


def flash_bound_s(call, dtype="bfloat16") -> float:
    """The least time of one call: the larger of its operations at the
    peak rate and its bytes (inputs read once, outputs written once) at
    the peak bandwidth."""
    kind, b, h, s, d = call
    e = 2 if dtype in ("bfloat16", "float16") else 4
    tile = b * h * s * d * e
    lse = b * h * s * 4
    ops, nbytes = {
        "fwd": (4.0 * b * h * s * s * d, 4 * tile + lse),          # q k v in, o out
        "dq": (6.0 * b * h * s * s * d, 6 * tile + 2 * lse),       # q k v o do in, dq out
        "dkv": (8.0 * b * h * s * s * d, 7 * tile + 2 * lse),      # q k v o do in, dk dv out
    }[kind]
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
