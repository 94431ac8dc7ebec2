"""The port's trainer and generator start from snapshots: the loading glue
of comat_tpu_torch/training/trainer.py and tools/generate.py at
--tiny_models on the CPU, on synthetic snapshots written with JAX's own
exporter (as tests/test_synthetic_snapshots.py::
test_trainer_loads_synthetic_snapshots writes them for JAX's trainer).

- `--pretrain_model` resolved through `--cache_dir`'s hub cache
  (refs/main), `--sdxl_unet_path` as a diffusers `unet/` folder,
  `--caption_model_path` (a repo id under the cache) and
  `--blip_tokenizer_vocab`: every tower holds the written values, the
  swapped-in UNet's over the snapshot's, BLIP's LM head restored from the
  word embeddings, the caption tokenizer WordPiece; SD1.5 and SDXL
  (text_encoder_2) as cases; no smoke fallback taken.
- A snapshot lacking a tensor is refused without --allow_smoke (at
  --tiny_models too) and taken, and listed, with it.
- D's base tensors are the generator's loaded objects (`is`).
- With --tune_vae and a bf16 VAE, the masters are the snapshot's fp32
  values, not the rounding of the working copy.
- `tools.generate --pretrain-model --checkpoint` (a LoRA file, and a
  checkpoint folder holding it) samples what a pipeline holding those
  weights samples, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from comat_tpu.config import BLIPConfig as JBLIPConfig
from comat_tpu.models import pipeline as jpipe
from comat_tpu.models.blip import BLIPCaptioner as JBLIP
from comat_tpu.models.hf_import import _clip_hf_name, _unet_hf_name, _vae_hf_name
from comat_tpu.tools.parity import export_hf_tensors
from comat_tpu_torch.models import hf_import as thf
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.text.tokenizer import BertWordPieceTokenizer, HashTokenizer
from comat_tpu_torch.training import arguments as targs
from comat_tpu_torch.training import checkpoints as tckpt
from comat_tpu_torch.training import trainer as ttrainer
from comat_tpu_torch.weights import from_jax_params

SUBS = {"unet": ("unet", _unet_hf_name, "diffusion_pytorch_model"),
        "vae": ("vae", _vae_hf_name, "diffusion_pytorch_model"),
        "text": ("text_encoder", _clip_hf_name, "model"),
        "text2": ("text_encoder_2", _clip_hf_name, "model")}
SD15_ID = "runwayml/stable-diffusion-v1-5"
PROMPTS = ["a red car and a blue bird", "two green cats on a mat"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run in parallel worker processes (pytest-xdist);
    one intra-op thread per worker keeps their torch work from
    oversubscribing the cores, which slows every worker many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _filled(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def _jax_tree(family, seed):
    pcfg = jpipe.make_pipeline_config(family, lora_rank=0, resolution=64, tiny=True)
    return _filled(jax.eval_shape(jpipe.DiffusionPipeline(pcfg).init_params,
                                  jax.random.PRNGKey(0)), seed)


def _hf(tree, tower):
    out = export_hf_tensors(tree[tower], SUBS[tower][1])
    return {k: v.reshape(-1) if k.endswith("ff.net.0.proj.bias") else v
            for k, v in out.items()}


def _write_snapshot(root, tree, drop=()):
    for tower, (sub, _, stem) in SUBS.items():
        if tower in tree:
            (root / sub).mkdir(parents=True)
            tensors = {k: v for k, v in _hf(tree, tower).items() if k not in drop}
            save_file(tensors, str(root / sub / f"{stem}.safetensors"))
    return root


def _hub(cache, repo_id, rev="c0ffee"):
    """cache/models--org--name/snapshots/<rev>, refs/main naming it."""
    base = cache / ("models--" + repo_id.replace("/", "--"))
    (base / "refs").mkdir(parents=True)
    (base / "refs" / "main").write_text(rev)
    return base / "snapshots" / rev


def _blip_tensors(seed=3):
    """A tiny BLIP under transformers' names, the tied LM head dropped."""
    model = JBLIP(JBLIPConfig.tiny())
    z = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            z, z + 1, z)
    sd = from_jax_params({"blip": _filled(shapes, seed)})["blip"]
    return {k: np.ascontiguousarray(v.numpy()) for k, v in sd.items()
            if k != "text_decoder.cls.predictions.decoder.weight"}


def _argv(tmp_path, *extra):
    (tmp_path / "p.txt").write_text("\n".join(PROMPTS))
    return ["--training_prompts", str(tmp_path / "p.txt"), "--output_dir",
            str(tmp_path / "out"), "--tiny_models", "--device", "cpu", "--resolution", "64",
            "--train_batch_size", "2", "--total_step", "4", "--K", "2", "--lora_rank", "4",
            *extra]


def _trainer(tmp_path, *extra):
    return ttrainer.Trainer(targs.parse_args(_argv(tmp_path, *extra)))


def _equal_towers(pipe, want, towers):
    for tower in towers:
        got = getattr(pipe, tower).state_dict()
        names = [n for n in want[tower] if "lora_" not in n]
        assert names and all(torch.equal(got[n], want[tower][n]) for n in names), tower


@pytest.mark.parametrize("family", ["sd_1_5", "sdxl"])
def test_trainer_loads_synthetic_snapshots(tmp_path, family):
    src, ft = _jax_tree(family, 1), _jax_tree(family, 2)
    cache = tmp_path / "cache"
    repo = SD15_ID if family == "sd_1_5" else "stabilityai/stable-diffusion-xl-base-1.0"
    snap = _write_snapshot(_hub(cache, repo), src)
    unet_dir = _write_snapshot(tmp_path / "ft", {"unet": ft["unet"]}) / "unet"
    blip_dir = _hub(cache, thf.CAPTION_MODEL_ID)
    blip_dir.mkdir(parents=True)
    written = _blip_tensors()
    save_file(written, str(blip_dir / "model.safetensors"))
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "red", "car"]))
    t = _trainer(tmp_path, "--pretrain_model_name", family, "--pretrain_model", repo,
                 "--cache_dir", str(cache), "--sdxl_unet_path", str(unet_dir),
                 "--caption_model_path", thf.CAPTION_MODEL_ID,
                 "--blip_tokenizer_vocab", str(vocab))
    assert t.snapshot == str(snap) and t.caption_dir == str(blip_dir)
    towers = ["vae", "text"] + (["text2"] if family == "sdxl" else [])
    assert sorted(t.load_reports) == sorted(towers + ["unet", "sdxl_unet_path",
                                                      "caption_model"])
    assert all(not r.missing and not r.unused for r in t.load_reports.values())
    assert t.smoke_fallbacks == []
    _equal_towers(t.pipeline, from_jax_params(src), towers)
    _equal_towers(t.pipeline, from_jax_params(ft), ["unet"])     # the swap won
    got = t.blip.state_dict()
    for n, v in thf.blip_from_hf(written).items():
        assert torch.equal(got[n], torch.from_numpy(np.asarray(v)).to(got[n].dtype)), n
    assert isinstance(t.caption_tok, BertWordPieceTokenizer)
    assert isinstance(t.clip_tok, HashTokenizer)


def test_snapshot_missing_a_tensor_raises_without_allow_smoke(tmp_path):
    gone = "decoder.conv_out.bias"
    snap = _write_snapshot(tmp_path / "snap", _jax_tree("sd_1_5", 1), drop=(gone,))
    with pytest.raises(RuntimeError, match=r"lacks 1 tensors \(first: \['vae\.decoder"
                                           r"\.conv_out\.bias'\]\).*--allow_smoke"):
        _trainer(tmp_path, "--pretrain_model", str(snap))
    t = _trainer(tmp_path, "--pretrain_model", str(snap), "--allow_smoke")
    assert t.load_reports["vae"].missing == [gone]
    assert [k for k, _ in t.smoke_fallbacks] == ["weights"]


def test_discriminator_base_is_the_loaded_generator(tmp_path):
    src = _jax_tree("sd_1_5", 1)
    snap = _write_snapshot(tmp_path / "snap", src)
    t = _trainer(tmp_path, "--pretrain_model", str(snap), "--gan_loss")
    assert not t.disc.gan_cfg.cross_arch
    g = dict(t.pipeline.unet.named_parameters())
    d = dict(t.disc.unet.named_parameters())
    shared = [n for n in g if "lora_" not in n]
    assert shared and all(d[n] is g[n] for n in shared)
    _equal_towers(t.pipeline, from_jax_params(src), ["unet"])


def test_tune_vae_masters_are_the_snapshot_fp32_values(tmp_path, monkeypatch):
    """A bf16 VAE (the full-width dtype) trained under --tune_vae: each
    master is the file's fp32 value, as JAX's fp32 leaf is; the working
    copy is its rounding."""
    make = ttrainer.make_pipeline_config

    def bf16_vae(*a, **k):
        cfg = make(*a, **k)
        return dataclasses.replace(cfg, vae=dataclasses.replace(cfg.vae,
                                                                dtype=torch.bfloat16))

    monkeypatch.setattr(ttrainer, "make_pipeline_config", bf16_vae)
    src = _jax_tree("sd_1_5", 1)
    snap = _write_snapshot(tmp_path / "snap", src)
    t = _trainer(tmp_path, "--pretrain_model", str(snap), "--tune_vae")
    want = from_jax_params(src)["vae"]
    masters = t.state.optimizer.masters
    work = t.pipeline.vae.state_dict()
    rounded_away = 0
    for n, w in want.items():
        m = masters[f"vae.{n}"]
        assert m.dtype == torch.float32 and torch.equal(m.detach(), w), n
        if work[n].dtype == torch.bfloat16:
            assert torch.equal(work[n], w.to(torch.bfloat16)), n
            rounded_away += int(not torch.equal(work[n].float(), w))
    assert rounded_away > 10


@pytest.mark.parametrize("form", ["file", "folder"])
def test_generate_from_a_snapshot_and_a_checkpoint(tmp_path, form):
    from comat_tpu_torch.tools.generate import main

    src = _jax_tree("sd_1_5", 1)
    snap = _write_snapshot(tmp_path / "snap", src)
    cfg = tpipe.make_pipeline_config("sd_1_5", lora_rank=4, resolution=64, tiny=True)
    weights = from_jax_params(src)
    ref = tpipe.DiffusionPipeline(cfg, device="cpu", seed=9)
    for tower in ("unet", "vae", "text"):
        getattr(ref, tower).load_state_dict(weights[tower], strict=False)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for n, p in ref.unet.named_parameters():
            if n.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=g))
    ckpt = tmp_path / "checkpoint-7"
    ckpt.mkdir()
    tckpt.export_lora_safetensors(
        str(ckpt / "pytorch_lora_weights.safetensors"),
        {f"unet.{n}": p for n, p in ref.unet.named_parameters() if "lora_" in n})
    path = ckpt if form == "folder" else ckpt / "pytorch_lora_weights.safetensors"
    images, _ = main(["--tiny", "--device", "cpu", "--resolution", "64",
                      "--num-inference-steps", "3", "--seed", "3",
                      "--out-dir", str(tmp_path / "gen"), "--pretrain-model", str(snap),
                      "--checkpoint", str(path), "--prompt", *PROMPTS])
    tok = HashTokenizer(cfg.text.vocab_size)
    enc, null = tok(PROMPTS, max_length=77), tok([""] * 2, max_length=77)
    want = ref.generate(enc["input_ids"], null["input_ids"], num_inference_steps=3,
                        eos_positions=enc["eos_positions"],
                        generator=torch.Generator().manual_seed(3))
    assert images.shape == (2, 64, 64, 3) and torch.equal(images, want)
    plain, _ = main(["--tiny", "--device", "cpu", "--resolution", "64",
                     "--num-inference-steps", "3", "--seed", "3",
                     "--out-dir", str(tmp_path / "gen"), "--pretrain-model", str(snap),
                     "--prompt", *PROMPTS])
    assert not torch.equal(images, plain)     # the LoRA counts
