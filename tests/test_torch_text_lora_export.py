"""The text towers' LoRA in the port's LoRA file: its export keys, its
import in both spellings, and the generator's --checkpoint.

- The port writes a text factor under the key the reference's
  LoraLoaderMixin writes,
  `text_encoder[_2].text_model.encoder.layers.N.self_attn.<proj>.lora_linear_layer.{down,up}.weight`;
  JAX's exporter writes `.lora.{down,up}` there
  (comat_tpu/models/hf_import.py:617). For the same tensors, the two files
  hold the same keys but for that infix and the same values (torch
  orientation, fp32).
- `hf_import.load_lora_state` reads both spellings into a pipeline whose
  text towers carry LoRA: every factor lands, none is missing or unused.
  JAX's loader reads the UNet's factors alone; the port follows the
  reference here.
- `tools.generate --checkpoint` builds its pipeline at the file's text
  rank, loads the text factors and samples as a pipeline holding them;
  the latent tool's and the evaluator's `load_sampler` loads them too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from comat_tpu.config import CLIPTextConfig as JCLIPConfig
from comat_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from comat_tpu.training.checkpoints import export_lora_safetensors as jexport
from comat_tpu_torch.models import hf_import as thf
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.text.tokenizer import HashTokenizer
from comat_tpu_torch.training import checkpoints as tckpt
from comat_tpu_torch.weights import from_jax_params
from torch_step_parity import seeded_params

RANK = 4
PROMPTS = ["a red cube", "two blue cats"]


def _jax_text_lora(seed):
    model = JCLIP(JCLIPConfig.tiny(), lora_rank=RANK)
    tree = seeded_params(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32),
                         seed=seed)
    lora = jax.tree_util.tree_map_with_path(
        lambda p, v: v if str(getattr(p[-1], "key", "")).startswith("lora_") else None, tree)
    return tree, lora


def test_text_lora_export_keys_beside_jax(tmp_path):
    (t1, l1), (t2, l2) = _jax_text_lora(1), _jax_text_lora(2)
    jexport(str(tmp_path / "jax.safetensors"), {"text": l1, "text2": l2})
    port = {}
    for tower, tree in (("text", t1), ("text2", t2)):
        sd = from_jax_params({tower: jax.tree_util.tree_map(np.asarray, tree)})[tower]
        port.update({f"{tower}.{n}": v for n, v in sd.items() if "lora_" in n})
    tckpt.export_lora_safetensors(str(tmp_path / "port.safetensors"), port)
    want, got = (load_file(str(tmp_path / f)) for f in ("jax.safetensors", "port.safetensors"))
    assert len(got) == len(port) == 2 * 2 * 4 * 2
    assert all(".lora_linear_layer." in k for k in got)
    assert {k.replace(".lora_linear_layer.", ".lora.") for k in got} == set(want)
    assert any(k.startswith("text_encoder_2.") for k in got)
    for k, v in got.items():
        w = want[k.replace(".lora_linear_layer.", ".lora.")]
        assert v.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(v, w)


def _trained_pipeline(seed=9):
    """A tiny SDXL pipeline with text LoRA, its factors all nonzero, as a
    trainer's would be; and its LoRA file's tensors."""
    cfg = tpipe.make_pipeline_config("sdxl", lora_rank=RANK, resolution=64, tiny=True,
                                     text_lora_rank=RANK)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu", seed=seed)
    g = torch.Generator().manual_seed(4)
    lora = {}
    with torch.no_grad():
        for tower in ("unet", "text", "text2"):
            for n, p in getattr(pipe, tower).named_parameters():
                if "lora_" in n:
                    if n.endswith("lora_b"):
                        p.copy_(0.1 * torch.randn(p.shape, generator=g))
                    lora[f"{tower}.{n}"] = p
    return pipe, lora


@pytest.mark.parametrize("spelling", ["reference", "jax"])
def test_both_spellings_load(tmp_path, spelling):
    ref, lora = _trained_pipeline()
    path = str(tmp_path / "pytorch_lora_weights.safetensors")
    tckpt.export_lora_safetensors(path, lora)
    if spelling == "jax":
        tensors = load_file(path)
        save_file({k.replace(".lora_linear_layer.", ".lora."): v
                   for k, v in tensors.items()}, path)
        assert sum(".lora." in k and k.startswith("text_encoder") for k in load_file(path))
    assert thf.lora_rank(path) == thf.lora_rank(path, "text") == RANK
    cfg = tpipe.make_pipeline_config("sdxl", lora_rank=RANK, resolution=64, tiny=True,
                                     text_lora_rank=RANK)
    fresh = tpipe.DiffusionPipeline(cfg, device="cpu", seed=1)
    reports = thf.load_lora_state(path, fresh)
    assert set(reports) == {"unet", "text", "text2"}
    assert all(r.missing == [] and r.unused == [] for r in reports.values())
    for name, p in lora.items():
        tower, n = name.split(".", 1)
        assert torch.equal(dict(getattr(fresh, tower).named_parameters())[n], p), name


def test_generate_checkpoint_loads_the_text_lora(tmp_path):
    from comat_tpu_torch.tools import gan_gt_generate
    from comat_tpu_torch.tools.generate import main

    ref, lora = _trained_pipeline()
    ckpt = tmp_path / "checkpoint-3"
    ckpt.mkdir()
    tckpt.export_lora_safetensors(str(ckpt / "pytorch_lora_weights.safetensors"), lora)
    args = ["--tiny", "--device", "cpu", "--model", "sdxl", "--resolution", "64",
            "--num-inference-steps", "3", "--seed", "9", "--checkpoint", str(ckpt)]
    images, _ = main([*args, "--out-dir", str(tmp_path / "gen"), "--prompt", *PROMPTS])
    tok, tok2 = HashTokenizer(ref.cfg.text.vocab_size), HashTokenizer(
        ref.cfg.text.vocab_size, pad_token_id=0)
    enc, null = tok(PROMPTS, max_length=77), tok([""] * 2, max_length=77)
    want = ref.generate(enc["input_ids"], null["input_ids"], num_inference_steps=3,
                        eos_positions=enc["eos_positions"],
                        input_ids2=tok2(PROMPTS, max_length=77)["input_ids"],
                        null_ids2=tok2([""] * 2, max_length=77)["input_ids"],
                        generator=torch.Generator().manual_seed(9))
    assert images.shape == (2, 64, 64, 3) and torch.equal(images, want)
    sampler = gan_gt_generate.load_sampler(gan_gt_generate.parse_args(
        ["--tiny", "--device", "cpu", "--model", "sdxl", "--resolution", "64", "--seed", "9",
         "--checkpoint", str(ckpt), "--prompt-path", "p.txt", "--save-path", "s"]), "latents")
    assert sampler.pipe.cfg.text_lora_rank == RANK
    got = {f"{t}.{n}": p for t in ("text", "text2")
           for n, p in getattr(sampler.pipe, t).named_parameters() if "lora_" in n}
    assert got and all(torch.equal(p, lora[n]) for n, p in got.items())
