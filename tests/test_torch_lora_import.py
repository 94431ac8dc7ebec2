"""The port's BLIP, LoRA and caption-tokenizer loaders against the JAX
package's, on synthetic files at tiny geometry on the CPU.

- BLIP: a tiny transformers `BlipForConditionalGeneration` saved with
  `safe_serialization=True` (the tied LM head dropped, as real snapshots
  drop it), loaded by JAX's `load_blip_params` and the port's
  `load_blip_state`: the port's tensors equal `weights.from_jax_params` of
  JAX's tree exactly, and the caption reward of one image agrees within
  1e-5 (one jitted JAX program). Skipped without transformers, as on the
  card's machine.
- LoRA: the port's export (`checkpoints.export_lora_safetensors`) read
  back by `load_lora_safetensors` is bit for bit; JAX's export (the
  reference's LoraLoaderMixin layout) and the attn-processor layout JAX's
  `_unet_hf_name` maps, both written from one JAX tree, import equal to
  `from_jax_params` of that tree (and of what JAX's own importer makes of
  the same file); `lora_rank` reads the rank from the file.
- The caption ids `assemble_batch` makes with the port's
  `BertWordPieceTokenizer` on a synthetic vocab.txt equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from comat_tpu.config import BLIPConfig as JBLIPConfig
from comat_tpu.config import UNetConfig as JUNetConfig
from comat_tpu.losses import caption_reward as jcr
from comat_tpu.models.blip import BLIPCaptioner as JBLIP
from comat_tpu.models.hf_import import _unet_hf_name, load_blip_params
from comat_tpu.models.hf_import import load_lora_safetensors as jload_lora
from comat_tpu.models.unet import UNet2DCondition
from comat_tpu.text.tokenizer import BertWordPieceTokenizer as JBert
from comat_tpu.text.tokenizer import HashTokenizer as JHash
from comat_tpu.training import data as jdata
from comat_tpu.training.checkpoints import export_lora_safetensors as jexport
from comat_tpu_torch.config import BLIPConfig
from comat_tpu_torch.losses import caption_reward as tcr
from comat_tpu_torch.models import hf_import as thf
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.models.blip import make_blip
from comat_tpu_torch.text.tokenizer import BertWordPieceTokenizer, HashTokenizer
from comat_tpu_torch.training import checkpoints as tckpt
from comat_tpu_torch.training import data as tdata
from comat_tpu_torch.weights import from_jax_params

PROMPTS = ["a red car and a blue bird", "Two CATS on a mat, sitting."]
RANK = 4


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


def test_blip_snapshot_loads_and_scores_as_jax(tmp_path):
    transformers = pytest.importorskip("transformers")
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.manual_seed(0)
    vcfg = transformers.BlipVisionConfig(
        image_size=64, patch_size=16, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64)
    tcfg = transformers.BlipTextConfig(
        vocab_size=1000, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, encoder_hidden_size=32, max_position_embeddings=512,
        is_decoder=True, bos_token_id=1)
    hf = transformers.BlipForConditionalGeneration(transformers.BlipConfig(
        text_config=tcfg.to_dict(), vision_config=vcfg.to_dict())).eval()
    with torch.no_grad():    # biases and norms away from their init, so a miss shows
        for p in hf.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn_like(p))
    hf.save_pretrained(str(tmp_path), safe_serialization=True)

    cap = jcr.build_caption_batch(JHash(1000), PROMPTS)
    model = JBLIP(JBLIPConfig.tiny())
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            *(jnp.asarray(cap[k][:1]) for k in
                              ("input_ids", "attention_mask", "labels")))
    loaded = jax.tree_util.tree_map(np.asarray,
                                    load_blip_params(str(tmp_path), _filled(shapes, 1)))
    image = np.random.default_rng(0).uniform(0, 1, (2, 80, 80, 3)).astype(np.float32)
    want = float(jax.jit(lambda p, img: jcr.blip_caption_reward(
        model, p, img, *(jnp.asarray(cap[k]) for k in
                         ("input_ids", "attention_mask", "labels"))))(loaded, image))

    blip = make_blip(BLIPConfig.tiny(), device="cpu", seed=9)
    report = thf.load_blip_state(str(tmp_path), blip)
    assert report.missing == [] and report.unused == [], (report.missing, report.unused)
    expected = from_jax_params({"blip": loaded})["blip"]
    got = blip.state_dict()
    assert set(got) == set(expected)
    for n, t in expected.items():
        assert torch.equal(got[n], t), n
    head = got["text_decoder.cls.predictions.decoder.weight"]
    assert torch.equal(head, got["text_decoder.bert.embeddings.word_embeddings.weight"])
    score = tcr.blip_caption_reward(blip, torch.from_numpy(image), cap["input_ids"],
                                    cap["attention_mask"], cap["labels"])
    assert abs(float(score) - want) <= 1e-5


def _port_unet(seed):
    cfg = tpipe.make_pipeline_config("sd_1_5", lora_rank=RANK, resolution=64, tiny=True)
    return tpipe.DiffusionPipeline(cfg, device="cpu", seed=seed).unet


def test_port_lora_export_imports_back_bit_for_bit(tmp_path):
    unet = _port_unet(1)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for n, p in unet.named_parameters():
            if n.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=g))
    lora = {f"unet.{n}": p for n, p in unet.named_parameters() if "lora_" in n}
    path = str(tmp_path / "pytorch_lora_weights.safetensors")
    tckpt.export_lora_safetensors(path, lora)
    assert thf.lora_rank(path) == RANK
    fresh = _port_unet(2)
    report = thf.load_lora_safetensors(path, fresh)
    assert report.missing == [] and report.unused == []
    got = dict(fresh.named_parameters())
    for name, p in lora.items():
        assert torch.equal(got[name[len("unet."):]], p.detach()), name


def _jax_lora_tree(seed):
    unet = UNet2DCondition(JUNetConfig.tiny(), lora_rank=RANK)
    shapes = jax.eval_shape(unet.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 32)))
    return _filled(shapes, seed)


def _lora_only(tree):
    return jax.tree_util.tree_map_with_path(
        lambda p, v: v if str(getattr(p[-1], "key", "")).startswith("lora_") else None, tree)


@pytest.mark.parametrize("layout", ["reference", "processor"])
def test_lora_layouts_written_from_jax_import_as_jax(tmp_path, layout):
    tree = _jax_lora_tree(4)
    path = str(tmp_path / "pytorch_lora_weights.safetensors")
    if layout == "reference":
        jexport(path, {"unet": _lora_only(tree)})
    else:
        # `<block>.attnX.processor.to_*_lora.{down,up}.weight`, torch
        # orientation: the inverse of `_unet_hf_name`'s transpose
        flat = {}

        def put(p, v):
            keys = tuple(str(getattr(k, "key", k)) for k in p)[1:]
            if keys[-1].startswith("lora_"):
                name, _ = _unet_hf_name(keys)
                flat[name] = np.ascontiguousarray(np.asarray(v).T)

        jax.tree_util.tree_map_with_path(put, tree)
        assert any(".processor.to_out_lora.up.weight" in k for k in flat)
        save_file(flat, path)
    jloaded, _ = jload_lora(path, _jax_lora_tree(5))
    jloaded = jax.tree_util.tree_map(np.asarray, jloaded)
    want = {n: t for n, t in from_jax_params({"unet": tree})["unet"].items() if "lora_" in n}
    from_jax = from_jax_params({"unet": jloaded})["unet"]
    unet = _port_unet(6)
    report = thf.load_lora_safetensors(path, unet)
    assert report.missing == [] and report.unused == []
    got = unet.state_dict()
    assert len(want) == sum("lora_" in n for n in got) > 0
    for n, t in want.items():
        assert torch.equal(got[n], t) and torch.equal(from_jax[n], t), n


def test_caption_ids_from_a_vocab_match_jax(tmp_path):
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "photography", "of", "red",
             "car", "and", "blue", "bird", "two", "cat", "##s", "on", "mat", ",", ".",
             "sit", "##ting", "[DEC]"]
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(words) + "\n")
    want = jdata.assemble_batch(PROMPTS, JHash(1000), JBert(str(vocab)))
    got = tdata.assemble_batch(PROMPTS, HashTokenizer(1000), BertWordPieceTokenizer(str(vocab)))
    keys = [k for k in want if k.startswith("caption")]
    assert keys and set(keys) == {k for k in got if k.startswith("caption")}
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k])
    # every word of the first prompt (after the captioner's prefix) is in
    # the vocabulary; the second's "sitting" splits into word pieces
    assert words.index("[UNK]") not in got["caption_ids"][0]
    assert words.index("##ting") in got["caption_ids"][1]
