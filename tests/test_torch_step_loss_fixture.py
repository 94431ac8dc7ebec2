"""The main-path milestone: the port's full-recipe loss reproduces the
recorded JAX step-loss fixture (fixtures/step_loss_sd15.json, written by
comat_tpu/tools/step_loss_fixture.py at its "tiny" geometry).

The inputs are rebuilt as `run_fixture` builds them, through the JAX
package's public builders, none of them edited: the seeded torch twins
(transformers' CLIP and BLIP, `TwinUNet` with nonzero LoRA up factors,
`TwinVAEDecoder`, a second `TwinUNet` for D) drawn in the same order,
converted by `convert_tree` into JAX trees (whose skeletons come from
`jax.eval_shape` of the JAX initialisers: every leaf the step reads is
the twin's), D's head from its own generator, the 64-px-aligned masks of
`_aligned_masks`, and the draws of the JAX step's rng (the schedule
start, the attribute-concentration draws at fold_in 0xA77C, the latents,
the noise table, the crop). `weights.from_jax_params` carries the trees
into the port, and the port's `make_loss_fn` runs the step's loss: B 2,
128^2, total_step 10, K 5, A 2, the GAN and attribute concentration on.

Tolerances, the fixture's own (`TOL`, `GRAD_TOL`): the step loss and each
recorded component within 1e-3 of the recorded JAX value; the norm of the
256 LoRA gradient leaves within 1e-3 relative of the recorded JAX norm.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu.tools import step_loss_fixture as fx

COMPONENTS = ["step_loss", "reward_blip", "G_loss", "token_loss", "pixel_loss"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run in parallel worker processes (pytest-xdist);
    one intra-op thread per worker keeps their torch work from
    oversubscribing the cores, which slows every worker many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _skeleton(init, *args):
    """The parameter tree of a JAX initialiser as zeros, without running
    it: convert_tree fills every leaf the twins hold."""
    shapes = jax.eval_shape(init, *args)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def inputs():
    import transformers

    from comat_tpu.config import BLIPConfig, UNetConfig
    from comat_tpu.losses.caption_reward import build_caption_batch
    from comat_tpu.losses.gan import Discriminator, GanConfig
    from comat_tpu.models.blip import BLIPCaptioner
    from comat_tpu.models.hf_import import (
        _blip_hf_name, _clip_hf_name, _unet_hf_name, _vae_hf_name, convert_tree,
    )
    from comat_tpu.models.pipeline import DiffusionPipeline, make_pipeline_config
    from comat_tpu.segmentation.interface import CenterPriorSegmenter, SegmenterHolder
    from comat_tpu.text.tokenizer import HashTokenizer
    from comat_tpu.tools.torch_twin_sd15 import TwinUNet, TwinVAEDecoder
    from comat_tpu.training.attrcon import attrcon_batch_fields, sample_attrcon_draws
    from comat_tpu.training.train_step import TrainConfig, sample_trained_idx

    G = fx.GEOMETRIES["tiny"]
    SEED, Bn, res, steps = fx.SEED, G["B"], G["resolution"], G["total_step"]
    prompts = fx.PROMPTS[:Bn]
    vocab = 1000

    # ---- the torch twins, drawn in run_fixture's order ----
    torch.manual_seed(SEED)
    text_t = transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=vocab, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=77, hidden_act="quick_gelu",
        bos_token_id=0, eos_token_id=999)).eval().float()
    unet_t = TwinUNet(lora_rank=G["lora_rank"]).eval().float()
    g_l = torch.Generator().manual_seed(SEED + 11)
    with torch.no_grad():
        for n, p in unet_t.named_parameters():
            if "_lora.up.weight" in n:
                p.copy_(torch.randn(p.shape, generator=g_l) * 0.05)
    vae_t = TwinVAEDecoder().eval().float()
    d_unet_t = TwinUNet().eval().float()
    g = torch.Generator().manual_seed(SEED + 7)
    d_head_w = torch.randn(1, 4, generator=g).numpy() * 0.5
    d_head_b = torch.randn(1, generator=g).numpy() * 0.1
    vcfg = transformers.BlipVisionConfig(
        image_size=64, patch_size=16, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64)
    tcfg_b = transformers.BlipTextConfig(
        vocab_size=vocab, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, encoder_hidden_size=32, max_position_embeddings=512,
        is_decoder=True, bos_token_id=1)
    blip_t = transformers.BlipForConditionalGeneration(transformers.BlipConfig(
        text_config=tcfg_b.to_dict(), vision_config=vcfg.to_dict())).eval().float()

    def sd_of(m):
        return {k: v.detach().numpy() for k, v in m.state_dict().items()}

    # ---- converted into JAX trees ----
    pcfg = make_pipeline_config("sd_1_5_attrcon", lora_rank=G["lora_rank"],
                                resolution=res, tiny=True)
    pipe = DiffusionPipeline(pcfg)
    params = _skeleton(pipe.init_params, jax.random.PRNGKey(SEED))
    params["unet"], miss_u = convert_tree(params["unet"], sd_of(unet_t), _unet_hf_name)
    params["text"], miss_t = convert_tree(params["text"], sd_of(text_t), _clip_hf_name)
    params["vae"], miss_v = convert_tree(params["vae"], sd_of(vae_t), _vae_hf_name)
    assert not miss_u
    assert all("text_projection" in m for m in miss_t)
    assert not [m for m in miss_v if m.startswith("decoder")]
    cap_tok = clip_tok = HashTokenizer(vocab)
    cap_batch = build_caption_batch(cap_tok, prompts)
    blip = BLIPCaptioner(BLIPConfig.tiny(vocab_size=vocab))
    blip_params = _skeleton(
        blip.init, jax.random.PRNGKey(SEED), jnp.zeros((1, 64, 64, 3)),
        jnp.asarray(cap_batch["input_ids"][:1]),
        jnp.asarray(cap_batch["attention_mask"][:1]),
        jnp.asarray(cap_batch["labels"][:1]))
    blip_params, miss_b = convert_tree(blip_params, sd_of(blip_t), _blip_hf_name)
    assert not miss_b
    disc = Discriminator(UNetConfig.tiny(), GanConfig(lora_rank=0))
    d_params = _skeleton(lambda k: disc.init_params(k, latent_size=res // 8,
                                                    context_dim=32),
                         jax.random.PRNGKey(SEED + 1))
    d_params["unet"], miss_d = convert_tree(d_params["unet"], sd_of(d_unet_t),
                                            _unet_hf_name)
    assert not miss_d
    d_params["head"] = {"params": {"mlp": {"kernel": d_head_w.T, "bias": d_head_b}}}

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
        "caption_labels": cap_batch["labels"], **fields,
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
    tree = jax.tree_util.tree_map(np.asarray, {**params, "blip": blip_params,
                                               "disc": d_params})
    return dict(tree=tree, batch=batch, tcfg=tcfg, trained_idx=trained_idx,
                attrcon_draws=attrcon_draws, latents0=latents0, noise=noise, crop=crop)


@pytest.fixture(scope="module")
def port_run(inputs):
    import dataclasses

    from comat_tpu_torch.config import BLIPConfig
    from comat_tpu_torch.losses.gan import Discriminator, GanConfig
    from comat_tpu_torch.models.blip import BLIPCaptioner
    from comat_tpu_torch.models.pipeline import DiffusionPipeline, make_pipeline_config
    from comat_tpu_torch.segmentation.interface import CenterPriorSegmenter, SegmenterHolder
    from comat_tpu_torch.training import train_step as tts
    from comat_tpu_torch.training.attrcon import make_attrcon_extra_losses
    from comat_tpu_torch.weights import from_jax_params

    G = fx.GEOMETRIES["tiny"]
    weights = from_jax_params(inputs["tree"])
    cfg = make_pipeline_config("sd_1_5_attrcon", lora_rank=G["lora_rank"],
                               resolution=G["resolution"], tiny=True)
    pipe = DiffusionPipeline(cfg, device="cpu", params=weights)
    blip = BLIPCaptioner(BLIPConfig.tiny()).requires_grad_(False)
    blip.load_state_dict(weights["blip"])
    disc = Discriminator(cfg.unet, GanConfig(lora_rank=0), device="cpu")
    disc.load_state_dict(weights["disc"])
    tcfg = tts.TrainConfig(**{f.name: getattr(inputs["tcfg"], f.name)
                              for f in dataclasses.fields(tts.TrainConfig)})
    extra = make_attrcon_extra_losses(
        pipe, SegmenterHolder(CenterPriorSegmenter(), max_words=4), tcfg)
    trainable = tts.partition_params(pipe)
    draws = tts.StepDraws(torch.tensor(inputs["latents0"]), torch.tensor(inputs["noise"]),
                          int(inputs["trained_idx"][0]), inputs["crop"],
                          tuple(int(i) for i in inputs["attrcon_draws"]))
    loss, (metrics, _) = tts.make_loss_fn(pipe, blip, tcfg, extra, disc)(
        inputs["batch"], draws)
    loss.backward()
    grads = [p.grad for p in trainable.values()]
    norm = float(torch.stack([g.double().square().sum() for g in grads]).sum().sqrt())
    return {k: float(v) for k, v in metrics.items()}, len(grads), norm


@pytest.fixture(scope="module")
def recorded():
    with open(fx.FIXTURE_PATH) as f:
        return json.load(f)


@pytest.mark.parametrize("key", COMPONENTS)
def test_fixture_loss_reproduced(port_run, recorded, key):
    got, want = port_run[0][key], recorded["jax"][key]
    assert abs(got - want) <= fx.TOL, (key, got, want)


def test_fixture_lora_gradient_norm_reproduced(port_run, recorded):
    summary = recorded["grad_summary"]
    assert port_run[1] == summary["n_lora_leaves"] == 256
    want = summary["grad_norm_jax"]
    assert abs(port_run[2] - want) <= fx.GRAD_TOL * want, (port_run[2], want)
