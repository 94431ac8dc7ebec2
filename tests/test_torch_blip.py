"""The port's BLIP reward (comat_tpu_torch/models/blip.py,
losses/caption_reward.py) against the JAX package, and its captioner
against transformers' BLIP, in fp32 on the CPU.

Same weights (the JAX module's, carried over by `weights.from_jax_params`)
and the same numpy inputs on both sides. Tolerances:
- caption loss 1e-5 absolute, its image gradient 1e-6 absolute: two
  tiny towers of fp32 GEMMs and LayerNorms, gradients of order 1e-2;
- blip_preprocess 1e-5 absolute (outputs of order one after the CLIP
  normalisation; both resize with the same separable bicubic kernel,
  a = -0.5, antialiased when shrinking), its VJP 1e-5 absolute;
- crop_jitter and build_caption_batch exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu.config import BLIPConfig as JBLIPConfig
from comat_tpu.losses import caption_reward as jcr
from comat_tpu.models.blip import BLIPCaptioner as JBLIP
from comat_tpu.text.tokenizer import HashTokenizer as JHashTokenizer
from comat_tpu_torch.config import BLIPConfig
from comat_tpu_torch.losses import caption_reward as tcr
from comat_tpu_torch.models.blip import BLIPCaptioner
from comat_tpu_torch.text.tokenizer import HashTokenizer
from comat_tpu_torch.weights import from_jax_params

PROMPTS = ["a red car and a blue bird", "Two CATS on a mat"]


@pytest.fixture(scope="module")
def blip_case():
    jax.config.update("jax_default_matmul_precision", "highest")
    cap = jcr.build_caption_batch(JHashTokenizer(1000), PROMPTS)
    model = JBLIP(JBLIPConfig.tiny())
    params = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.asarray(cap["input_ids"][:1]), jnp.asarray(cap["attention_mask"][:1]),
        jnp.asarray(cap["labels"][:1]),
    )
    image = np.random.default_rng(0).uniform(0, 1, (2, 80, 80, 3)).astype(np.float32)
    return cap, model, params, image


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_caption_reward_and_image_gradient_match_jax(blip_case, smoothing):
    import dataclasses

    cap, _, params, image = blip_case
    jmodel = JBLIP(dataclasses.replace(JBLIPConfig.tiny(), label_smoothing=smoothing))

    def reward(img):
        return jcr.blip_caption_reward(
            jmodel, params, img, jnp.asarray(cap["input_ids"]),
            jnp.asarray(cap["attention_mask"]), jnp.asarray(cap["labels"]))

    want, want_grad = jax.value_and_grad(reward)(jnp.asarray(image))
    blip = BLIPCaptioner(BLIPConfig(**{
        **dataclasses.asdict(BLIPConfig.tiny()), "label_smoothing": smoothing}))
    blip.load_state_dict(from_jax_params(
        {"blip": jax.tree_util.tree_map(np.asarray, params)})["blip"])
    blip.requires_grad_(False)
    x = torch.tensor(image, requires_grad=True)
    got = tcr.blip_caption_reward(blip, x, cap["input_ids"], cap["attention_mask"],
                                  cap["labels"])
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-5
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), atol=1e-6, rtol=0)
    assert float(np.abs(np.asarray(want_grad)).max()) > 1e-4


@pytest.mark.parametrize("shape,size", [((2, 126, 126, 3), 64),
                                        ((1, 510, 510, 3), 384),
                                        ((1, 255, 255, 3), 384)])
def test_blip_preprocess_matches_jax(shape, size):
    """Shrinking (126 -> 64, the recipe's 510 -> 384 crop) and growing
    (the 256^2 run's 255 -> 384), values and VJP."""
    rng = np.random.default_rng(1)
    image = rng.uniform(0, 1, shape).astype(np.float32)
    cot = rng.standard_normal((shape[0], size, size, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jcr.blip_preprocess(x, size), jnp.asarray(image))
    (want_grad,) = vjp(jnp.asarray(cot))
    x = torch.tensor(image, requires_grad=True)
    got = tcr.blip_preprocess(x, size)
    got.backward(torch.tensor(cot))
    assert got.shape == (shape[0], size, size, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(2, 510, 510, 3), (1, 255, 255, 3)])
def test_blip_preprocess_resize_matches_interpolate_in_fp64(shape):
    """The resize (two products with `F.interpolate`'s weights, whose
    gradient has no float atomics on a card) against `F.interpolate`
    itself, bicubic antialiased, in fp64: values within 1e-6, the VJP
    within 1e-6 of its largest magnitude (the products run in fp32;
    `F.interpolate` in fp32 is 2.4e-5 off fp64)."""
    rng = np.random.default_rng(3)
    image = rng.uniform(0, 1, shape)
    cot = rng.standard_normal((shape[0], 384, 384, 3))
    x64 = torch.tensor(image, requires_grad=True)
    want = torch.nn.functional.interpolate(
        x64.permute(0, 3, 1, 2), size=(384, 384), mode="bicubic", antialias=True,
        align_corners=False).permute(0, 2, 3, 1)
    want.backward(torch.tensor(cot))
    mean = torch.tensor(tcr.CLIP_IMAGE_MEAN, dtype=torch.float64)
    std = torch.tensor(tcr.CLIP_IMAGE_STD, dtype=torch.float64)
    x = torch.tensor(image, dtype=torch.float32, requires_grad=True)
    got = tcr.blip_preprocess(x)
    (got * torch.tensor(cot * std.numpy(), dtype=torch.float32)).sum().backward()
    np.testing.assert_allclose(got.detach().double() * std + mean, want.detach(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(x.grad.double(), x64.grad,
                               atol=1e-6 * float(x64.grad.abs().max()), rtol=0)


def test_crop_jitter_matches_jax():
    image = np.random.default_rng(2).standard_normal((2, 10, 10, 3)).astype(np.float32)
    want = jcr.crop_jitter(jnp.asarray(image), jnp.int32(1), jnp.int32(2), 8)
    got = tcr.crop_jitter(torch.tensor(image), 1, 2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_build_caption_batch_matches_jax():
    for vocab in (1000, 30524):
        want = jcr.build_caption_batch(JHashTokenizer(vocab), PROMPTS)
        got = tcr.build_caption_batch(HashTokenizer(vocab), PROMPTS)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
        assert (got["labels"][:, :3] == tcr.IGNORE_INDEX).all()


def test_caption_loss_matches_transformers_blip():
    """An independent implementation: transformers' BLIP at tiny geometry,
    its state dict with the tied LM-head weight dropped as a safetensors
    snapshot drops it, loaded through `weights.blip_from_hf`. The HF loss
    takes NCHW pixels; label smoothing is 0 on both sides. 1e-5."""
    import transformers

    from comat_tpu_torch.weights import blip_from_hf

    torch.manual_seed(0)
    vcfg = transformers.BlipVisionConfig(
        image_size=64, patch_size=16, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64)
    tcfg = transformers.BlipTextConfig(
        vocab_size=1000, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, encoder_hidden_size=32,
        max_position_embeddings=512, is_decoder=True, bos_token_id=1,
        label_smoothing=0.0)
    hf = transformers.BlipForConditionalGeneration(transformers.BlipConfig(
        text_config=tcfg.to_dict(), vision_config=vcfg.to_dict())).eval()
    sd = dict(hf.state_dict())
    del sd["text_decoder.cls.predictions.decoder.weight"]
    blip = BLIPCaptioner(BLIPConfig.tiny())
    blip.load_state_dict(blip_from_hf(sd))
    cap = tcr.build_caption_batch(HashTokenizer(1000), PROMPTS)
    ids, mask, labels = (torch.tensor(cap[k]).long()
                         for k in ("input_ids", "attention_mask", "labels"))
    pix = torch.randn(2, 64, 64, 3)
    with torch.no_grad():
        want = hf(pixel_values=pix.permute(0, 3, 1, 2), input_ids=ids,
                  attention_mask=mask, labels=labels).loss
        got = blip.caption_loss(pix, ids, mask, labels)
    assert abs(float(got) - float(want)) <= 1e-5
