"""The split step of an image-dependent segmenter (Grounded-SAM) in the
port: the no-grad presample (training/train_step.py `make_presample`),
the segmentation of its image (`SegmenterHolder.device_masks`) and the
differentiable step replaying the presample's tables
(`pipeline.forward(presampled=...)`), alone and inside the trainer.

No JAX here: the port against itself on the CPU at tiny geometry (64^2,
total_step 4, K 2, LoRA rank 4 with nonzero `lora_b`). The stand-in
segmenter makes a top band per noun whose height follows the image's
mean red, so its masks are a function of the pixels it was given, as
tests/test_multichip_gsam.py's is for JAX. Equalities are exact: on the
CPU the presample's pass 1 is the unsplit step's pass 1 op for op.
"""

import json

import numpy as np
import pytest
import torch

from comat_tpu_torch.config import BLIPConfig
from comat_tpu_torch.models.blip import make_blip
from comat_tpu_torch.models.pipeline import DiffusionPipeline, make_pipeline_config
from comat_tpu_torch.segmentation import interface as seg_iface
from comat_tpu_torch.text.tokenizer import HashTokenizer
from comat_tpu_torch.training import train_step as tts
from comat_tpu_torch.training.arguments import parse_args
from comat_tpu_torch.training.attrcon import attrcon_batch_fields, make_attrcon_extra_losses
from comat_tpu_torch.training.data import assemble_batch
from comat_tpu_torch.training.trainer import Trainer

PROMPTS = ["a red car and a blue bird", "two green cats on a mat"]
RES = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under xdist several workers share the cores: one intra-op thread
    per worker keeps their torch work from oversubscribing them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class BandSegmenter:
    """Image-dependent stand-in with GroundedSAMSegmenter's surface: per
    noun a top band of height H * mean(red), within [H/4, H/2]. Records
    each batch call's images and nouns."""

    image_dependent = True

    def __init__(self):
        self.calls = []

    def __call__(self, image01, nouns):
        H, W, _ = image01.shape
        r = int(np.clip(round(H * float(image01[..., 0].mean())), H // 4, H // 2))
        m = np.zeros((H, W), np.float32)
        m[:r] = 1.0
        return [m for _ in nouns]

    def batch(self, images01, nouns_list, mark=None):
        self.calls.append((images01.clone(), [list(n) for n in nouns_list]))
        if mark is not None:
            mark("segment_device")
        return [self(img, nouns) for img, nouns in zip(images01, nouns_list)]


@pytest.fixture(scope="module")
def tiny():
    cfg = make_pipeline_config("sd_1_5_attrcon", lora_rank=4, resolution=RES, tiny=True)
    pipe = DiffusionPipeline(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in pipe.unet.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    blip = make_blip(BLIPConfig.tiny(), device="cpu", seed=1)
    tcfg = tts.TrainConfig(total_step=4, K=2, resolution=RES, attrcon=True,
                           attrcon_train_steps=2)
    tok = HashTokenizer(cfg.text.vocab_size)
    holder = seg_iface.SegmenterHolder(BandSegmenter())
    batch = assemble_batch(PROMPTS, tok, HashTokenizer(BLIPConfig.tiny().vocab_size),
                           max_length=cfg.text.max_length)
    batch.update(attrcon_batch_fields(PROMPTS, tok, holder, cfg.text.max_length,
                                      resolution=RES))
    draws = tts.sample_draws(tcfg, len(PROMPTS), cfg.latent_size,
                             torch.Generator().manual_seed(3))
    return pipe, blip, tcfg, holder, batch, draws


def _loss_and_grads(pipe, blip, tcfg, holder, batch, draws):
    trainable = tts.partition_params(pipe)
    for p in trainable.values():
        p.grad = None
    loss_fn = tts.make_loss_fn(pipe, blip, tcfg, make_attrcon_extra_losses(pipe, holder, tcfg))
    loss, (metrics, _) = loss_fn(batch, draws)
    loss.backward()
    return loss.detach(), metrics, {n: p.grad.clone() for n, p in trainable.items()}


def test_split_step_equals_the_unsplit_step_given_the_same_masks(tiny):
    pipe, blip, tcfg, holder, batch, draws = tiny
    assert "seg_masks" not in batch            # image-dependent: none at batch time
    clock = tts.PhaseClock(torch.device("cpu"))
    image, eps_table, traj = tts.make_presample(pipe, tcfg)(batch, draws, clock)
    masks = holder.device_masks(image, mark=clock.mark)
    assert image.shape == (2, RES, RES, 3)
    assert masks.dtype == torch.uint8 and masks.shape == (2, holder.max_words, RES, RES)
    # the segmenter saw the presample's image, clipped to [0, 1], in one call
    (seen, nouns), = holder.segmenter.calls
    assert torch.equal(seen, image.float().clamp(0, 1))
    assert nouns == holder.nouns and any(nouns)
    assert 0 < int(masks.sum()) < masks.numel()
    for name in ("presample", "presample_pass1", "presampled", "segment_device",
                 "segmented"):
        assert len(clock.marks[name]) == 1

    unsplit = _loss_and_grads(pipe, blip, tcfg, holder, dict(batch, seg_masks=masks), draws)
    split = _loss_and_grads(pipe, blip, tcfg, holder,
                            dict(batch, seg_masks=masks, eps_table=eps_table,
                                 latents_traj=traj), draws)
    assert torch.equal(split[0], unsplit[0])
    assert all(torch.equal(split[1][k], unsplit[1][k]) for k in unsplit[1])
    assert split[2].keys() == unsplit[2].keys() and len(split[2]) > 0
    for name, g in unsplit[2].items():
        assert torch.equal(split[2][name], g), name
    assert float(unsplit[1]["token_loss"]) > 0


def test_trainer_takes_the_split_step_with_an_image_dependent_segmenter(tmp_path,
                                                                       monkeypatch):
    stub = BandSegmenter()
    # --tiny_models builds the center prior; swap in the stand-in there
    monkeypatch.setattr(seg_iface, "CenterPriorSegmenter", lambda: stub)
    (tmp_path / "p.txt").write_text("\n".join(PROMPTS * 2) + "\n")
    args = parse_args([
        "--training_prompts", str(tmp_path / "p.txt"), "--output_dir", str(tmp_path / "out"),
        "--pretrain_model_name", "sd_1_5_attrcon", "--tiny_models", "--device", "cpu",
        "--train_batch_size", "2", "--seed", "0", "--total_step", "4", "--K", "2",
        "--attrcon_train_steps", "1", "--resolution", str(RES), "--lora_rank", "4",
        "--max_train_steps", "2", "--validation_steps", "0"])
    t = Trainer(args)
    assert t.seg_holder.segmenter is stub and t.presample is not None
    # the first step's presample image, from the trainer's own generator state
    prompts = next(iter(t.dataset.epoch(0)))
    gen = torch.Generator().set_state(t.generator.get_state())
    draws = tts.sample_draws(t.tcfg, 2, t.pcfg.latent_size, gen)
    batch = t._batch(prompts)
    want, _, _ = t.presample(batch, draws)
    stub.calls.clear()
    t.train()

    assert len(stub.calls) == 2                 # one batch call a step
    first, nouns = stub.calls[0]
    assert torch.equal(first, want.float().clamp(0, 1))
    for images, _ in stub.calls:
        assert images.shape == (2, RES, RES, 3)
        assert 0.0 <= float(images.min()) and float(images.max()) <= 1.0
    assert {"car", "bird"} <= {n for ns in nouns for n in ns}
    rows = [json.loads(line) for line in open(tmp_path / "out" / "metrics.jsonl")
            if line.strip()]
    rows = [r for r in rows if "token_loss" in r]
    assert len(rows) == 2
    for r in rows:
        assert np.isfinite(r["step_loss"]) and r["token_loss"] > 0 and r["pixel_loss"] > 0
        assert r["s_presample"] > 0 and r["s_segment"] > 0
        assert r["s_segment"] >= r["s_segment_host"] >= 0
