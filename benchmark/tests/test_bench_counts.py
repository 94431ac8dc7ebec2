"""The operation and byte counts of benchmark/work/counts.py against sums
worked by hand, and each tower's forward against torch's FlopCounterMode
over the plain reference module on the meta device."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import models
from benchmark.work import counts

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


# SDXL's UNet at its published widths (stabilityai/stable-diffusion-xl-base-1.0)
SDXL_UNET = dict(in_channels=4, out_channels=4, block_out_channels=[320, 640, 1280],
                 down_block_types=["down", "cross", "cross"],
                 up_block_types=["cross", "cross", "up"], layers_per_block=2,
                 transformer_layers_per_block=[0, 2, 10], attention_heads=[5, 10, 20],
                 cross_attention_dim=2048, norm_num_groups=32, addition_embed_type="text_time",
                 addition_time_embed_dim=256, projection_class_embeddings_input_dim=2816)


def config(name):
    if name == "sdxl":
        return dict(config("sd15"), unet=SDXL_UNET)
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


def test_one_conv():
    # 2 images of 8 x 8 outputs, 3 -> 5 channels, 3 x 3: B H W k k Cin Cout multiply-adds
    assert counts.conv(2, 8, 8, 3, 5) == 2 * (2 * 8 * 8 * 9 * 3 * 5) == 34560


def test_one_attention():
    # Q K^T and P V over 2 x 4096 tokens, 8 heads of 40: 2 * (2 * 4096 * 4096 * 320) each
    assert counts.attn_core(2, 4096, 4096, 320) == 2 * 2 * (2 * 4096 * 4096 * 320)
    # the forward kernel's least time: 4 B H S^2 d at 989 TFLOP/s, or q, k, v in and o out
    # in bf16 plus the fp32 LSE at 3.35 TB/s, whichever is longer
    ops = 4 * 2 * 8 * 4096 * 4096 * 40
    nbytes = 4 * 2 * 8 * 4096 * 40 * 2 + 2 * 8 * 4096 * 4
    assert counts.flash_bound_s(("fwd", 2, 8, 4096, 40)) == pytest.approx(
        max(ops / 989e12, nbytes / 3.35e12), rel=1e-12)
    assert ops / 989e12 > nbytes / 3.35e12      # bound by operations


def test_one_sd15_unet_forward_by_hand():
    """SD1.5's UNet over one 64 x 64 latent, summed layer by layer."""
    u = config("sd15")["unet"]
    lin = attn = 0.0
    conv = lambda hw, ci, co, k=3: 2.0 * hw * hw * k * k * ci * co  # noqa: E731
    mm = lambda m, ci, co: 2.0 * m * ci * co  # noqa: E731

    def resnet(hw, ci, co):
        return conv(hw, ci, co) + conv(hw, co, co) + (conv(hw, ci, co, 1) if ci != co else 0) \
            + mm(1, 1280, co)

    def transformer(hw, c):
        n = hw * hw
        return (2 * mm(n, c, c) + 4 * mm(n, c, c) + 2 * mm(n, c, c) + 2 * mm(77, 768, c)
                + mm(n, c, 8 * c) + mm(n, 4 * c, c)), 4.0 * n * n * c + 4.0 * n * 77 * c

    lin += mm(1, 320, 1280) + mm(1, 1280, 1280) + conv(64, 4, 320)
    # down: (64, 320), (32, 640), (16, 1280) with transformers; (8, 1280) without
    cin = 320
    for hw, c, cross in ((64, 320, 1), (32, 640, 1), (16, 1280, 1), (8, 1280, 0)):
        for j in range(2):
            lin += resnet(hw, cin if j == 0 else c, c)
            if cross:
                a, b = transformer(hw, c)
                lin, attn = lin + a, attn + b
        cin = c
        if hw > 8:
            lin += conv(hw // 2, c, c)
    lin += 2 * resnet(8, 1280, 1280)
    a, b = transformer(8, 1280)
    lin, attn = lin + a, attn + b
    skips = [320, 320, 320, 320, 640, 640, 640, 1280, 1280, 1280, 1280, 1280]
    cur = 1280
    for hw, c, cross in ((8, 1280, 0), (16, 1280, 1), (32, 640, 1), (64, 320, 1)):
        for _ in range(3):
            lin += resnet(hw, cur + skips.pop(), c)
            cur = c
            if cross:
                a, b = transformer(hw, c)
                lin, attn = lin + a, attn + b
        if hw < 64:
            lin += conv(hw * 2, c, c)
    lin += conv(64, 320, 4)
    got = counts.unet_fwd(u, 1, 64)
    assert got["lin"] == lin and got["attn"] == attn
    assert (lin + attn) / 1e12 == pytest.approx(0.803, abs=5e-4)


@pytest.mark.parametrize("name", ["sd15", "sdxl"])
def test_towers_against_flop_counter(name):
    cfg = config(name)
    u = cfg["unet"]
    with torch.device("meta"):
        added = ({"text_embeds": torch.zeros(2, 1280), "time_ids": torch.zeros(2, 6)}
                 if u.get("addition_embed_type") else None)
        cases = [
            (models.UNet(u), lambda m: m(torch.zeros(2, 4, 64, 64), torch.tensor([10]),
                                         torch.zeros(2, 77, u["cross_attention_dim"]), added),
             counts.unet_fwd(u, 2, 64)),
            (models.VAEDecoder(cfg["vae"]), lambda m: m(torch.zeros(2, 4, 64, 64)),
             counts.vae_decoder_fwd(cfg["vae"], 2, 64)),
            (models.CLIPText(cfg["text"]), lambda m: m(torch.zeros(2, 77, dtype=torch.long)),
             counts.clip_fwd(cfg["text"], 2)),
            (models.BLIPCaptioner(cfg["blip"]),
             lambda m: m.caption_loss(torch.zeros(2, 3, 384, 384),
                                      torch.zeros(2, 24, dtype=torch.long),
                                      torch.ones(2, 24, dtype=torch.long),
                                      torch.zeros(2, 24, dtype=torch.long)),
             counts.blip_fwd(cfg["blip"], 2, 24)),
        ]
        for module, call, want in cases:
            with FlopCounterMode(display=False) as fc:
                call(module)
            assert fc.get_total_flops() == counts.total(want), type(module).__name__


def test_step_counts_depend_only_on_the_configuration():
    cfg = config("sd15")
    tc = dict(resolution=512, lora_rank=128, K=5, total_step=50, attrcon_train_steps=2)
    step = counts.train_step_flops(cfg, tc, 4)
    g2 = counts.unet_fwd(cfg["unet"], 8, 64, rank=128)
    assert step["pass1"] == 50 * counts.total(g2)
    assert step["replay"] == 5 * (counts.total(g2) + g2["lin"] + 2 * g2["attn"])
    assert sum(step.values()) / 1e12 == pytest.approx(468.0, abs=0.5)
    # 15 self-attentions of the UNet over >= 64 tokens: pass 1, replay and captures
    calls = counts.flash_calls(cfg, tc, 4)
    assert sum(1 for c in calls if c[0] == "fwd") == 16 * (50 + 5 + 2) + 1
