"""The CoMat training step in plain PyTorch, float32, TF32 off: the
benchmark's reference for the trainer cells.

It recomputes, from the benchmark's seeded weights (`weights.make`) and the
step's random draws worked out again from the run's seed (`draws`):
the text encoding (CLIP-L; SDXL's two towers, the pooled embed and the
size ids), pass 1 (50 guided DDPM steps), the replay of the K trained
steps with their gradient (the scheduler chain attached from the first
trained step, a UNet gradient only at the trained steps, pass 1's values
elsewhere), the cross-attention capture at the drawn segments, the VAE
decode, the crop and the BLIP caption reward, the GAN's G loss and the
grounding losses (token and pixel), the clipped AdamW update of the
generator's LoRA factors, and the discriminator's update (its loss on the
detached final latents against the ground-truth latents, a clipped AdamW
with beta1 0). The algorithm is the reference CoMat trainer's
(training_script.py, TrainableSDPipeline.py, gan_sdxl.py,
tc_loss_utils.py), written with the reference's loops.

What it takes from the run besides the seed: the host batch the trainer
assembled (token ids, caption ids and labels, the attribute groups'
token indices, the ground-truth latents drawn from the latent store) and
the segmentation masks, which it cannot recompute (see PERF.md, "How
`correct` is decided"). Each UNet call and each image's decode that the
backward needs is checkpointed, so that a step fits on one card.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import models

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


# ---------------------------------------------------------------- schedule

def ddpm_tables(total_step: int, T: int = 1000, beta_start=0.00085, beta_end=0.012):
    """(timesteps, per-step (a, b, sigma) with x' = a x + b eps + sigma n):
    diffusers' DDPMScheduler, scaled_linear betas, "leading" spacing with
    steps_offset 1, fixed_small variance, epsilon prediction, no clipping."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, T, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    ratio = T // total_step
    ts = (np.arange(total_step) * ratio).round()[::-1].astype(np.int64) + 1
    rows = []
    for t in ts:
        prev = t - ratio
        ap, app = acp[t], (acp[prev] if prev >= 0 else 1.0)
        cur_a = ap / app
        cur_b = 1.0 - cur_a
        c_x0 = math.sqrt(app) * cur_b / (1.0 - ap)
        c_x = math.sqrt(cur_a) * (1.0 - app) / (1.0 - ap)
        a = c_x0 / math.sqrt(ap) + c_x
        b = -c_x0 * math.sqrt(1.0 - ap) / math.sqrt(ap)
        var = max((1.0 - app) / (1.0 - ap) * cur_b, 1e-20)
        rows.append((a, b, math.sqrt(var) if t > 0 else 0.0))
    return ts, rows


# ---------------------------------------------------------------- draws

def interval(tc) -> int:
    return tc["total_step"] // tc["K"]


def step_draws(tc, B: int, size: int, generator: torch.Generator):
    """One step's random inputs from `generator`, in the trainer's order:
    the initial latents (B, s, s, 4), the per-step noise (S, B, s, s, 4),
    then the first trained step, the crop offsets and the segments where
    the cross-attention maps are captured."""
    dev = generator.device
    latents0 = torch.randn((B, size, size, 4), generator=generator, device=dev)
    noise = torch.randn((tc["total_step"], B, size, size, 4), generator=generator, device=dev)
    offsets = tc["resolution"] // 224
    n_cap = min(tc["attrcon_train_steps"], tc["K"])
    ints = torch.randint(0, 1 << 30, (3 + n_cap,), generator=generator, device=dev).tolist()
    max_start = tc["total_step"] - interval(tc) * (tc["K"] - 1) - 1
    return dict(latents0=latents0, noise=noise, start=ints[0] % (max_start + 1),
                crop=(ints[1] % (offsets + 1), ints[2] % (offsets + 1)),
                capture=[i % tc["K"] for i in ints[3:]])


# ---------------------------------------------------------------- losses

def grounding_losses(maps: List[torch.Tensor], masks, token_idx, token_valid, word_valid):
    """(token loss, pixel loss) summed over the batch for one layer key:
    `maps` the layer's (B, heads, N, 77) probabilities of the prompts'
    half, masks (B, W, H, W) binary. The reference's per-word loops
    (tc_loss_utils.py:66-167): the token loss is (1 - the share of a
    token's attention inside its word's mask)^2, meaned over heads and
    over the word's tokens, per map; the pixel loss is the binary
    cross-entropy of the word's map (its tokens summed over the heads'
    and maps' mean, clipped to [0, 1]) against the mask."""
    B, heads, N, _ = maps[0].shape
    res = int(round(N ** 0.5))
    m = F.interpolate(masks.float(), size=(res, res), mode="bilinear", antialias=True)
    m = (m > 0.0).float().reshape(B, -1, N)
    avg = torch.stack([a.mean(dim=1) for a in maps]).mean(0)
    tok_sum = torch.zeros((), device=masks.device)
    pix_sum = torch.zeros((), device=masks.device)
    for b in range(B):
        words = [w for w in range(token_idx.shape[1]) if word_valid[b, w]]
        for w in words:
            toks = [int(t) for t, ok in zip(token_idx[b, w], token_valid[b, w]) if ok]
            mw = m[b, w]
            for a in maps:
                obj = torch.zeros((), device=masks.device)
                for t in toks:
                    ca = a[b, :, :, t]
                    act = (ca * mw).sum(-1) / ca.sum(-1).clamp_min(1e-12)
                    obj = obj + (1.0 - act.mean()) ** 2
                tok_sum = tok_sum + obj / max(len(toks), 1) / len(words)
            wmap = avg[b][:, toks].sum(-1).clamp(0.0, 1.0)
            logp = torch.log(wmap.clamp_min(1e-44)).clamp_min(-100.0)
            log1m = torch.log((1.0 - wmap).clamp_min(1e-44)).clamp_min(-100.0)
            pix_sum = pix_sum - (mw * logp + (1.0 - mw) * log1m).mean() / len(words)
    return tok_sum, pix_sum


def bce_logits(x, target: float):
    return F.binary_cross_entropy_with_logits(x, torch.full_like(x, target))


# ---------------------------------------------------------------- the step

class ClippedAdamW:
    """A global-norm clip (the gradient scaled by max_norm / norm when the
    norm reaches max_norm) and torch's AdamW, over named leaves."""

    def __init__(self, leaves: Dict[str, torch.Tensor], lr, b1, b2, eps, wd, max_norm):
        self.leaves, self.max_norm = leaves, max_norm
        self.adam = torch.optim.AdamW(list(leaves.values()), lr=lr, betas=(b1, b2),
                                      eps=eps, weight_decay=wd)

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """Clip, update, zero; returns the clipped gradients (the norm
        before the clip in `last_norm`)."""
        for p in self.leaves.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = torch.stack([p.grad.square().sum() for p in self.leaves.values()]).sum().sqrt()
        self.last_norm = float(norm)
        if float(norm) >= self.max_norm:
            for p in self.leaves.values():
                p.grad.mul_(self.max_norm / norm)
        grads = {n: p.grad.clone() for n, p in self.leaves.items()}
        self.adam.step()
        for p in self.leaves.values():
            p.grad = None
        return grads


class ReferenceTrainer:
    """The step on the reference towers. `cfg`: the configuration file's
    contents (tower sizes, `pipeline`, `train`: the recipe's numbers);
    `w`: `weights.make(cfg, seed, device)`."""

    def __init__(self, cfg: dict, w: Dict[str, Dict[str, torch.Tensor]], device):
        self.cfg, self.tc, self.device = cfg, cfg["train"], device
        self.sdxl = bool(cfg.get("text2"))

        def build(cls, sub, tensors):
            with torch.device("meta"):
                mod = cls(sub)
            mod = mod.to_empty(device=device)
            state = {n: t.float() for n, t in tensors.items()
                     if not n.endswith(("lora_a", "lora_b"))}
            mod.load_state_dict(state, strict=True)
            return mod.requires_grad_(False).eval()

        self.unet = build(models.UNet, cfg["unet"], w["unet"])
        self.vae = build(models.VAEDecoder, cfg["vae"], w["vae"])
        self.text = build(models.CLIPText, cfg["text"], w["text"])
        self.text2 = build(models.CLIPText, cfg["text2"], w["text2"]) if self.sdxl else None
        self.blip = build(models.BLIPCaptioner, cfg["blip"], w["blip"])
        self.d_unet = (build(models.UNet, cfg["d_unet"], w["d_unet"]) if cfg.get("d_unet")
                       else self.unet)
        tc = self.tc
        # the trained leaves, under the measured trainer's names
        self.g = {f"unet.{n}": t.float().clone().requires_grad_()
                  for n, t in w["unet"].items() if n.endswith(("lora_a", "lora_b"))}
        self.d = {f"unet.{n}": t.float().clone().requires_grad_() for n, t in w["d_lora"].items()}
        self.d.update({f"head.{n}": t.float().clone().requires_grad_()
                       for n, t in w["d_head"].items()})
        self.g_opt = ClippedAdamW(self.g, tc["learning_rate"], tc["adam_beta1"],
                                  tc["adam_beta2"], tc["adam_epsilon"], tc["adam_weight_decay"],
                                  tc["max_grad_norm"])
        self.d_opt = ClippedAdamW(self.d, tc["learning_rate_D"], tc["adam_beta1_D"],
                                  tc["adam_beta2_D"], tc["adam_epsilon"],
                                  tc["adam_weight_decay"], tc["max_grad_norm_D"])
        self.ts, self.coef = ddpm_tables(tc["total_step"])

    # -- the towers
    def _factors(self, leaves):
        return {n[len("unet."):]: t for n, t in leaves.items() if n.startswith("unet.")}

    def g_unet(self, x, t, ctx, added=None, capture=()):
        self.unet.set_lora(self._factors(self.g))
        return self.unet(x, t, ctx, added, capture)

    def d_logits(self, x, t, ctx, added=None, frozen=False):
        """D's logits (B, h, w, 1); `frozen`: no gradient reaches D (the G
        loss)."""
        d = {n: v.detach() for n, v in self.d.items()} if frozen else self.d
        self.d_unet.set_lora(self._factors(d))
        out, _ = self.d_unet(x, t, ctx, added)
        h = out.permute(0, 2, 3, 1)
        return h @ d["head.mlp.weight"].t() + d["head.mlp.bias"]

    def encode(self, ids, ids2=None, eos=None):
        """(context, pooled or None)."""
        if not self.sdxl:
            return self.text(ids)[0], None
        h1, _ = self.text(ids, skip=1, eos=eos)
        h2, pooled = self.text2(ids if ids2 is None else ids2, skip=1, eos=eos)
        return torch.cat([h1, h2], dim=-1), pooled

    def added(self, pooled, B):
        if pooled is None:
            return None
        r = float(self.tc["resolution"])
        ids = torch.tensor([[r, r, 0.0, 0.0, r, r]], device=pooled.device).expand(B, 6)
        return {"text_embeds": pooled, "time_ids": ids}

    def guided(self, x, t, ctx, nctx, ac, nac):
        x2 = torch.cat([x, x])
        c2 = torch.cat([nctx, ctx])
        a2 = None if ac is None else {k: torch.cat([nac[k], ac[k]]) for k in ac}
        out, _ = self.g_unet(x2, t, c2, a2)
        u, c = out.chunk(2)
        return u + self.tc["cfg_scale"] * (c - u)

    def ddpm(self, i, x, eps, noise):
        a, b, s = self.coef[i]
        return a * x + b * eps + s * noise

    # -- one step
    def step(self, batch, masks, draws) -> Dict[str, object]:
        """One training step; returns the losses, the generator's clipped
        gradients and D's, their norms before the clip, and the final
        latents (B, h, w, 4)."""
        tc, dev = self.tc, self.device

        def t_(key, dtype=torch.long):
            return torch.as_tensor(np.asarray(batch[key]), device=dev).to(dtype)

        ids, null = t_("input_ids"), t_("null_ids")
        eos = t_("eos_positions") if batch.get("eos_positions") is not None else None
        ids2 = t_("input_ids2") if batch.get("input_ids2") is not None else None
        null2 = t_("null_ids2") if batch.get("null_ids2") is not None else None
        B = ids.shape[0]
        with torch.no_grad():
            ctx, pooled = self.encode(ids, ids2, eos)
            nctx, npooled = self.encode(null, null2)
            ac, nac = self.added(pooled, B), self.added(npooled, B)
            d_ctx = self.text(null)[0] if self.cfg.get("d_unet") else nctx
            d_ac = None if self.cfg.get("d_unet") else nac
        S = tc["total_step"]
        noise = draws["noise"].permute(0, 1, 4, 2, 3).to(dev)
        # pass 1, without gradients
        x = draws["latents0"].permute(0, 3, 1, 2).to(dev)
        traj, eps_tab = [], []
        with torch.no_grad():
            for i in range(S):
                traj.append(x)
                eps = self.guided(x, int(self.ts[i]), ctx, nctx, ac, nac)
                eps_tab.append(eps)
                x = self.ddpm(i, x, eps, noise[i])
        # the replay: a UNet gradient at the trained steps only
        trained = [draws["start"] + interval(tc) * k for k in range(tc["K"])]
        x = traj[trained[0]]
        entries = {}
        for i in range(trained[0], S):
            if i in trained:
                entries[trained.index(i)] = x
                eps = checkpoint(self.guided, x, int(self.ts[i]), ctx, nctx, ac, nac,
                                 use_reentrant=False)
            else:
                eps = eps_tab[i]
            x = self.ddpm(i, x, eps, noise[i])
        latents = x
        # one image at a time: the decoder's activations at full resolution
        # are the reference's largest
        scale = self.cfg["vae"]["scaling_factor"]
        image = torch.cat([checkpoint(lambda z: self.vae(z / scale), latents[i:i + 1],
                                      use_reentrant=False) for i in range(B)]) / 2.0 + 0.5
        size = tc["resolution"] - tc["resolution"] // 224
        ox, oy = draws["crop"]
        crop = image[:, :, ox:ox + size, oy:oy + size]
        bs = self.cfg["blip"]["image_size"]
        pix = F.interpolate(crop, size=(bs, bs), mode="bicubic", antialias=True)
        mean = torch.tensor(CLIP_MEAN, device=dev)[:, None, None]
        std = torch.tensor(CLIP_STD, device=dev)[:, None, None]
        caption = self.blip.caption_loss((pix - mean) / std, t_("caption_ids"),
                                         t_("caption_mask"), t_("caption_labels"))
        loss = tc["reward_weight"] * caption
        t_final = int(self.ts[-1])
        g_loss = bce_logits(self.d_logits(latents, t_final, d_ctx, d_ac, frozen=True), 1.0)
        loss = loss + tc["gan_loss_weight"] * g_loss
        token = torch.zeros((), device=dev)
        pixel = torch.zeros((), device=dev)
        m = torch.as_tensor(np.asarray(masks), device=dev)
        tidx, tval, wval = (np.asarray(batch[k]) for k in ("token_idx", "token_valid",
                                                           "word_valid"))
        keys = tuple(self.cfg["pipeline"]["capture_layers"])
        for a in sorted(set(draws["capture"])):
            i = trained[a]
            caps = checkpoint(
                lambda x, t=int(self.ts[i]): self.g_unet(x, t, ctx, ac, capture=keys)[1],
                entries[a], use_reentrant=False)
            for key in keys:
                if key in caps:
                    tl, pl = grounding_losses(caps[key], m, tidx, tval, wval)
                    token, pixel = token + tl, pixel + pl
        token, pixel = token / B, pixel / B
        loss = loss + tc["mask_token_loss_weight"] * token + tc["mask_pixel_loss_weight"] * pixel
        loss.backward()
        g_grads = self.g_opt.step()
        # D's update on the detached final latents (label 0) and the
        # ground-truth latents (label 1)
        gt = torch.as_tensor(np.asarray(batch["gt_latents"]), device=dev).permute(0, 3, 1, 2)
        lat2 = torch.cat([latents.detach(), gt.float()])
        dac2 = None if d_ac is None else {k: torch.cat([v, v]) for k, v in d_ac.items()}
        logits = self.d_logits(lat2, t_final, torch.cat([d_ctx, d_ctx]), dac2)
        target = torch.cat([torch.zeros_like(logits[:B]), torch.ones_like(logits[B:])])
        d_loss = F.binary_cross_entropy_with_logits(logits, target)
        d_loss.backward()
        d_grads = self.d_opt.step()
        vals = {k: float(v.detach()) for k, v in (
            ("step_loss", loss), ("D_loss", d_loss), ("G_loss", g_loss),
            ("reward_blip", -caption), ("token_loss", token), ("pixel_loss", pixel))}
        return {**vals, "g_grads": g_grads, "d_grads": d_grads,
                "latents": latents.detach().permute(0, 2, 3, 1).cpu().numpy(),
                "g_norm": self.g_opt.last_norm, "d_norm": self.d_opt.last_norm}
