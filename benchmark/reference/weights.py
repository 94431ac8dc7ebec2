"""Seeded weights for both sides of the comparison, made by the benchmark.

Each tower's tensors are drawn in one `torch.randn` call on the device
from a generator seeded by the run's seed and the tower's index, then cut
into the tower's tensors in name order: a tensor of two or more dims is
N(0, 1/fan_in), a LoRA `lora_a` N(0, 1/rank^2) and `lora_b` 0 (diffusers'
LoRA initialisation), a bias 0, a norm scale 1. The towers are served in
bfloat16, so their tensors are rounded to it once here; LoRA factors and
the discriminator's head stay float32, as they are trained. The names are
the reference modules' (diffusers' and transformers' state-dict names, a
LoRA factor as `<projection>.lora_a` / `.lora_b`).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

from . import models

# the index of each tower in the seed of its generator
TOWERS = ("unet", "vae", "text", "text2", "blip", "d_lora", "d_head", "d_unet")


def shapes_of(module: torch.nn.Module) -> List[Tuple[str, Tuple[int, ...]]]:
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


def lora_shapes(unet_cfg, rank: int) -> List[Tuple[str, Tuple[int, ...]]]:
    with torch.device("meta"):
        unet = models.UNet(unet_cfg)
    out = []
    for path, (cin, cout) in unet.lora_names():
        out += [(f"{path}.lora_a", (cin, rank)), (f"{path}.lora_b", (rank, cout))]
    return out


def draw(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int, index: int,
         device, served=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The tensors of `shapes`, drawn from one generator in one call."""
    shapes = list(shapes)
    total = sum(_numel(s) for _, s in shapes)
    g = torch.Generator(device=device).manual_seed(seed * len(TOWERS) + index)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes:
        n = _numel(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if name.endswith("lora_b"):
            out[name] = torch.zeros(shape, device=device)
        elif name.endswith("lora_a"):
            out[name] = x / shape[1]
        elif len(shape) >= 2:
            fan_in = _numel(shape[1:])
            out[name] = (x * fan_in ** -0.5).to(served)
        elif name.endswith("bias"):
            out[name] = torch.zeros(shape, device=device, dtype=served)
        else:
            out[name] = torch.ones(shape, device=device, dtype=served)
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def make(cfg: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every tower the configuration `cfg` names, by tower:
    unet (with the generator's LoRA factors), vae (the decoder), text,
    text2 (SDXL), blip, d_lora (the discriminator's factors on its UNet),
    d_head (its Linear(4 -> 1), `mlp.weight`, `mlp.bias`) and, for a
    discriminator of another architecture than the generator, d_unet."""
    rank = cfg["train"]["lora_rank"]
    with torch.device("meta"):
        towers = {"unet": models.UNet(cfg["unet"]), "vae": models.VAEDecoder(cfg["vae"]),
                  "text": models.CLIPText(cfg["text"]),
                  "blip": models.BLIPCaptioner(cfg["blip"])}
        if cfg.get("text2"):
            towers["text2"] = models.CLIPText(cfg["text2"])
        d_cfg = cfg.get("d_unet")
        if d_cfg:
            towers["d_unet"] = models.UNet(d_cfg)
    out = {}
    for name, module in towers.items():
        shapes = shapes_of(module)
        if name == "unet":
            shapes += lora_shapes(cfg["unet"], rank)
        out[name] = draw(shapes, seed, TOWERS.index(name), device)
    out["d_lora"] = draw(lora_shapes(d_cfg or cfg["unet"], rank), seed,
                         TOWERS.index("d_lora"), device)
    out["d_head"] = draw([("mlp.weight", (1, 4)), ("mlp.bias", (1,))], seed,
                         TOWERS.index("d_head"), device, served=torch.float32)
    return out
