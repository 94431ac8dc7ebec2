"""The port's full-recipe loss at SD1.5's real geometry against the
recorded JAX fixture (fixtures/step_loss_sd15_geometry.json, written by
comat_tpu/tools/step_loss_fixture.py at its "real" geometry).

The inputs are rebuilt as `run_fixture` builds them for that geometry,
through the JAX package's public builders, as
tests/test_torch_step_loss_fixture.py rebuilds the tiny ones: the seeded
torch twins drawn in the same order (transformers' CLIP-L at the 49408
vocabulary, `TwinUNet` at (320, 640, 1280, 1280) x 8 heads with LoRA 128
and nonzero up factors, `TwinVAEDecoder` at (128, 256, 512, 512), a second
`TwinUNet` for D, BLIP-large), each converted by `convert_tree` into the
skeleton `jax.eval_shape` gives of its JAX initialiser and carried into
the port by `weights.from_jax_params` before the next twin is drawn (so
that no more than one twin is held at a time); D's head from its own
generator, the 64-px-aligned masks, and the draws of the JAX step's rng.
No JAX step runs. The port's `make_loss_fn` runs the step's loss in fp32
on the CPU: B 1, 256^2, total_step 4, K 2, A 2, the GAN and attribute
concentration on; pass 1 through the LoRA'd UNet (`fuse_pass1=False`,
which keeps a fused copy of the UNet out of memory).

Gates, the fixture's own (`TOL`, `GRAD_TOL`): the step loss and each
recorded component within 1e-3 of the recorded JAX value; the norm of the
256 LoRA gradient leaves within 1e-3 relative of the recorded JAX norm.

Marked slow, outside tier-1:

    python -m pytest tests/test_torch_step_loss_real_geometry.py -m slow

It took 141 s and 259 s in two runs on 8 CPU cores (a shared machine), peak
resident memory 15.5 GiB.
"""

import dataclasses
import gc
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu.tools import step_loss_fixture as fx

pytestmark = pytest.mark.slow

COMPONENTS = ["step_loss", "reward_blip", "G_loss", "token_loss", "pixel_loss"]


def _skeleton(init, *args):
    """The parameter tree of a JAX initialiser as zeros, without running
    it (np.zeros pages stay untouched until written)."""
    shapes = jax.eval_shape(init, *args)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _sd_of(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def run():
    import transformers

    from comat_tpu.config import BLIPConfig as JBLIPConfig
    from comat_tpu.config import CLIPTextConfig as JCLIPConfig
    from comat_tpu.config import UNetConfig as JUNetConfig
    from comat_tpu.config import VAEConfig as JVAEConfig
    from comat_tpu.losses.caption_reward import build_caption_batch
    from comat_tpu.losses.gan import Discriminator as JDiscriminator
    from comat_tpu.losses.gan import GanConfig as JGanConfig
    from comat_tpu.models.blip import BLIPCaptioner as JBLIPCaptioner
    from comat_tpu.models.hf_import import (
        _blip_hf_name, _clip_hf_name, _unet_hf_name, _vae_hf_name, convert_tree,
    )
    from comat_tpu.models.pipeline import DiffusionPipeline as JPipeline
    from comat_tpu.models.pipeline import PipelineConfig as JPipelineConfig
    from comat_tpu.segmentation.interface import CenterPriorSegmenter, SegmenterHolder
    from comat_tpu.text.tokenizer import HashTokenizer
    from comat_tpu.tools.torch_twin_sd15 import TwinUNet, TwinVAEDecoder
    from comat_tpu.training.attrcon import attrcon_batch_fields, sample_attrcon_draws
    from comat_tpu.training.train_step import TrainConfig, sample_trained_idx
    from comat_tpu_torch.config import BLIPConfig
    from comat_tpu_torch.losses.gan import Discriminator, GanConfig
    from comat_tpu_torch.models.blip import make_blip
    from comat_tpu_torch.models.pipeline import DiffusionPipeline, make_pipeline_config
    from comat_tpu_torch.segmentation import interface as port_seg
    from comat_tpu_torch.training import train_step as tts
    from comat_tpu_torch.training.attrcon import make_attrcon_extra_losses
    from comat_tpu_torch.weights import from_jax_params

    G = fx.GEOMETRIES["real"]
    SEED, Bn, res, steps = fx.SEED, G["B"], G["resolution"], G["total_step"]
    prompts = fx.PROMPTS[:Bn]
    f32 = jnp.float32
    jcfg = JPipelineConfig(
        unet=dataclasses.replace(JUNetConfig.sd15(), dtype=f32),
        text=dataclasses.replace(JCLIPConfig.sd15(), dtype=f32),
        vae=dataclasses.replace(JVAEConfig.sd15(), dtype=f32),
        attrcon=True, capture_layers=G["capture_layers"], lora_rank=G["lora_rank"],
        resolution=res)
    skeleton = _skeleton(JPipeline(jcfg).init_params, jax.random.PRNGKey(SEED))

    def port_tower(key, tree):
        out = from_jax_params({key: jax.tree_util.tree_map(np.asarray, tree)})[key]
        gc.collect()
        return out

    def converted(key, twin, mapper, jax_tree):
        tree, missing = convert_tree(jax_tree, _sd_of(twin), mapper)
        return port_tower(key, tree), missing

    # ---- the torch twins, drawn in run_fixture's order, one at a time ----
    torch.manual_seed(SEED)
    text_t = transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=49408, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
        num_attention_heads=12, max_position_embeddings=77, hidden_act="quick_gelu",
        bos_token_id=1, eos_token_id=2)).eval().float()
    text_sd, miss_t = converted("text", text_t, _clip_hf_name, skeleton["text"])
    del text_t
    unet_kw = dict(block_out=(320, 640, 1280, 1280), heads=8, ctx_dim=768, groups=32)
    unet_t = TwinUNet(lora_rank=G["lora_rank"], **unet_kw).eval().float()
    g_l = torch.Generator().manual_seed(SEED + 11)
    with torch.no_grad():
        for n, p in unet_t.named_parameters():
            if "_lora.up.weight" in n:
                p.copy_(torch.randn(p.shape, generator=g_l) * 0.05)
    unet_sd, miss_u = converted("unet", unet_t, _unet_hf_name, skeleton["unet"])
    del unet_t
    vae_t = TwinVAEDecoder(block_out=(128, 256, 512, 512), layers_per_block=2,
                           groups=32).eval().float()
    vae_tree, miss_v = convert_tree(skeleton["vae"], _sd_of(vae_t), _vae_hf_name)
    del vae_t, skeleton
    vae_sd = port_tower("vae", vae_tree)
    del vae_tree
    assert not miss_u
    assert all("text_projection" in m for m in miss_t)
    assert not [m for m in miss_v if m.startswith("decoder")]

    cfg = dataclasses.replace(
        make_pipeline_config("sd_1_5_attrcon", lora_rank=G["lora_rank"], resolution=res),
        capture_layers=G["capture_layers"])
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, dtype=torch.float32),
                              text=dataclasses.replace(cfg.text, dtype=torch.float32),
                              vae=dataclasses.replace(cfg.vae, dtype=torch.float32))
    pipe = DiffusionPipeline(cfg, device="cpu", fuse_pass1=False,
                             params={"unet": unet_sd, "text": text_sd, "vae": vae_sd})
    del unet_sd, text_sd, vae_sd
    gc.collect()

    d_unet_t = TwinUNet(**unet_kw).eval().float()
    g = torch.Generator().manual_seed(SEED + 7)
    d_head_w = torch.randn(1, 4, generator=g).numpy() * 0.5
    d_head_b = torch.randn(1, generator=g).numpy() * 0.1
    jdisc = JDiscriminator(dataclasses.replace(JUNetConfig.sd15(), dtype=f32),
                           JGanConfig(lora_rank=0))
    d_params = _skeleton(lambda k: jdisc.init_params(k, latent_size=res // 8,
                                                     context_dim=768),
                         jax.random.PRNGKey(SEED + 1))
    d_params["unet"], miss_d = convert_tree(d_params["unet"], _sd_of(d_unet_t),
                                            _unet_hf_name)
    del d_unet_t
    assert not miss_d
    d_params["head"] = {"params": {"mlp": {"kernel": d_head_w.T, "bias": d_head_b}}}
    disc_sd = port_tower("disc", d_params)
    del d_params
    disc = Discriminator(cfg.unet, GanConfig(lora_rank=0), device="cpu")
    disc.load_state_dict(disc_sd)
    del disc_sd
    gc.collect()

    vcfg = transformers.BlipVisionConfig(
        image_size=384, patch_size=16, hidden_size=1024, num_hidden_layers=24,
        num_attention_heads=16, intermediate_size=4096)
    tcfg_b = transformers.BlipTextConfig(
        vocab_size=30524, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
        intermediate_size=3072, encoder_hidden_size=1024, max_position_embeddings=512,
        is_decoder=True, bos_token_id=30522)
    blip_t = transformers.BlipForConditionalGeneration(transformers.BlipConfig(
        text_config=tcfg_b.to_dict(), vision_config=vcfg.to_dict())).eval().float()
    clip_tok, cap_tok = HashTokenizer(49408), HashTokenizer(30524)
    cap_batch = build_caption_batch(cap_tok, prompts)
    jblip = JBLIPCaptioner(dataclasses.replace(JBLIPConfig.large(), dtype=f32))
    blip_params = _skeleton(
        jblip.init, jax.random.PRNGKey(SEED), jnp.zeros((1, 384, 384, 3)),
        jnp.asarray(cap_batch["input_ids"][:1]),
        jnp.asarray(cap_batch["attention_mask"][:1]),
        jnp.asarray(cap_batch["labels"][:1]))
    blip_sd, miss_b = converted("blip", blip_t, _blip_hf_name, blip_params)
    del blip_t, blip_params
    assert not miss_b
    blip = make_blip(dataclasses.replace(BLIPConfig.large(), dtype=torch.float32),
                     device="cpu", params=blip_sd)
    del blip_sd
    gc.collect()

    # ---- the batch and the draws ----
    tcfg = TrainConfig(total_step=steps, K=G["K"], guidance_scale=fx.CFG_SCALE,
                       resolution=res, gan_loss=True, gan_loss_weight=1.0,
                       attrcon=True, attrcon_train_steps=G["A"],
                       mask_token_loss_weight=1e-3, mask_pixel_loss_weight=5e-5)
    enc, null = clip_tok(prompts, max_length=77), clip_tok([""] * Bn, max_length=77)
    holder = SegmenterHolder(CenterPriorSegmenter(), max_words=4)
    fields = attrcon_batch_fields(prompts, clip_tok, holder, 77, resolution=res)
    batch = {
        "input_ids": enc["input_ids"], "eos_positions": enc["eos_positions"],
        "null_ids": null["input_ids"], "caption_ids": cap_batch["input_ids"],
        "caption_mask": cap_batch["attention_mask"],
        "caption_labels": cap_batch["labels"],
        **{k: np.asarray(v) for k, v in fields.items()},
        "seg_masks": fx._aligned_masks(np.asarray(fields["word_valid"]), res),
    }
    rng0 = jax.random.fold_in(jax.random.PRNGKey(SEED + 3), 0)
    rngs = jax.random.split(rng0, 4)
    trained_idx = np.asarray(sample_trained_idx(rngs[0], tcfg))
    attrcon_draws = np.asarray(sample_attrcon_draws(rng0, tcfg))
    rng_noise, lrng = jax.random.split(rngs[1])
    h = res // 8
    latents0 = np.asarray(jax.random.normal(lrng, (Bn, h, h, 4)))
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng_noise, i),
                                                   (Bn, h, h, 4)))
                      for i in range(steps)])
    crop = tuple(int(jax.random.randint(r, (), 0, res // 224 + 1)) for r in rngs[2:])

    # ---- the port's loss and its LoRA gradients ----
    ptcfg = tts.TrainConfig(**{f.name: getattr(tcfg, f.name)
                               for f in dataclasses.fields(tts.TrainConfig)})
    extra = make_attrcon_extra_losses(
        pipe, port_seg.SegmenterHolder(port_seg.CenterPriorSegmenter(), max_words=4), ptcfg)
    trainable = tts.partition_params(pipe)
    draws = tts.StepDraws(torch.tensor(latents0), torch.tensor(noise), int(trained_idx[0]),
                          crop, tuple(int(i) for i in attrcon_draws))
    loss, (metrics, _) = tts.make_loss_fn(pipe, blip, ptcfg, extra, disc)(batch, draws)
    loss.backward()
    grads = [p.grad for p in trainable.values()]
    norm = float(torch.stack([g.double().square().sum() for g in grads]).sum().sqrt())
    return {k: float(v) for k, v in metrics.items()}, len(grads), norm


@pytest.fixture(scope="module")
def recorded():
    with open(fx.FIXTURE_PATH_REAL) as f:
        return json.load(f)


@pytest.mark.parametrize("key", COMPONENTS)
def test_real_geometry_loss_reproduced(run, recorded, key):
    got, want = run[0][key], recorded["jax"][key]
    assert abs(got - want) <= fx.TOL, (key, got, want)


def test_real_geometry_lora_gradient_norm_reproduced(run, recorded):
    summary = recorded["grad_summary"]
    assert run[1] == summary["n_lora_leaves"] == 256
    want = summary["grad_norm_jax"]
    assert abs(run[2] - want) <= fx.GRAD_TOL * want, (run[2], want)
