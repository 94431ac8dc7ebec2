"""The port's evaluator (`tools/evaluate.py`) against the JAX package's, on
the CPU at tiny geometry in fp32.

- The BLIP-VQA binding scorer: the port's `make_bvqa_scorer` and JAX's,
  both loading one tiny transformers `BlipForQuestionAnswering` snapshot
  with a synthetic WordPiece vocabulary, on the same images and prompts:
  the same questions, P(yes) within 1e-5 (JAX rounds its to 6 digits, so
  1e-5 covers that too), binding and mean within 1e-5.
- The per-image BLIP reward (`caption_reward.blip_caption_rewards`, one
  batched forward) against JAX's `vmap` of the scalar reward on the
  same weights and 48-token captions, within 1e-5.
- The CLI at --tiny --device cpu, as tests/test_tools.py's
  `test_evaluate_cli_tiny` checks JAX's.
- The full-size gates print their SKIPPED lines and build no model; real
  VQA weights without a vocabulary exit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu.config import BLIPConfig as JBLIPConfig
from comat_tpu.losses import caption_reward as jcr
from comat_tpu.models.blip import BLIPCaptioner as JBLIP
from comat_tpu.tools import evaluate as jeval
from comat_tpu_torch.config import BLIPConfig
from comat_tpu_torch.losses import caption_reward as tcr
from comat_tpu_torch.models import blip_vqa as tvqa
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.models.blip import make_blip
from comat_tpu_torch.text.tokenizer import HashTokenizer
from comat_tpu_torch.tools import evaluate as teval
from comat_tpu_torch.weights import from_jax_params

TOL = 1e-5
PROMPTS = ["a red car and a blue bird", "a cat", "three green apples on a wooden table"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "yes", "no", "?", "a", "red", "car",
         "blue", "bird", "cat", "green", "apple", "##s", "wooden", "table", "three", "on",
         "and"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per xdist worker, so that parallel test files do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    torch.set_num_threads(threads)


def _images(n=3, size=64):
    return np.random.default_rng(4).uniform(0, 1, (n, size, size, 3)).astype(np.float32)


def test_bvqa_scorer_matches_jax(tmp_path):
    transformers = pytest.importorskip("transformers")
    vcfg = transformers.BlipVisionConfig(
        image_size=64, patch_size=16, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64)
    tcfg = transformers.BlipTextConfig(
        vocab_size=1000, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, encoder_hidden_size=32, max_position_embeddings=512,
        bos_token_id=1)
    torch.manual_seed(5)
    hf = transformers.BlipForQuestionAnswering(transformers.BlipConfig(
        text_config=tcfg.to_dict(), vision_config=vcfg.to_dict())).eval()
    with torch.no_grad():   # spread P(yes) away from 1/2
        for p in hf.parameters():
            p.mul_(3.0)
    snap = tmp_path / "vqa"
    hf.save_pretrained(str(snap), safe_serialization=True)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    flags = ["--prompt-path", "unused.txt", "--tiny", "--vqa-model-path", str(snap),
             "--vqa-tokenizer-vocab", str(vocab), "--max-questions", "2"]
    jscore = jeval.make_bvqa_scorer(jeval.parse_args(flags), JBLIPConfig.tiny())
    tscore = teval.make_bvqa_scorer(teval.parse_args(flags + ["--device", "cpu"]),
                                    BLIPConfig.tiny(), "cpu")
    images = _images()
    want = jscore(jnp.asarray(images), PROMPTS)
    got = tscore(torch.from_numpy(images), PROMPTS)
    assert [r["bvqa_questions"] for r in got] == [r["bvqa_questions"] for r in want]
    assert got[0]["bvqa_questions"] == ["red car?", "blue bird?"]
    assert got[1]["bvqa_questions"] == ["a cat?"]       # no group: the prompt
    ps = [p for r in want for p in r["bvqa_p_yes"]]
    assert max(ps) - min(ps) > 0.05
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["bvqa_p_yes"], w["bvqa_p_yes"], atol=TOL, rtol=0)
        for k in ("bvqa_binding", "bvqa_mean_p_yes"):
            assert abs(g[k] - w[k]) <= TOL, (k, g[k], w[k])


def test_per_image_reward_matches_jax_vmap():
    jcfg = JBLIPConfig.tiny()
    blip = JBLIP(jcfg)
    H = jcfg.image_size
    shapes = jax.eval_shape(blip.init, jax.random.PRNGKey(0), jnp.zeros((1, H, H, 3)),
                            jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32),
                            jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    tok = HashTokenizer(jcfg.vocab_size)
    cap = jcr.build_caption_batch(tok, PROMPTS)
    S = teval.CAPTION_LENGTH

    def pad(a, v):
        return np.pad(a, ((0, 0), (0, max(S - a.shape[1], 0))), constant_values=v)[:, :S]

    ids, mask, labels = (pad(cap["input_ids"], 0), pad(cap["attention_mask"], 0),
                         pad(cap["labels"], -100))
    images = _images(size=96)       # resized to the captioner's 64

    def one(img, i, m, lab):
        return jcr.blip_caption_reward(blip, params, img[None], i[None], m[None], lab[None])

    want = np.asarray(jax.vmap(one)(*(jnp.asarray(a) for a in (images, ids, mask, labels))))
    port = make_blip(BLIPConfig.tiny(), device="cpu",
                     params=from_jax_params({"blip": params})["blip"])
    got = tcr.blip_caption_rewards(port, torch.from_numpy(images), ids, mask, labels)
    assert got.shape == (3,) and len(set(np.round(want, 4))) == 3
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # each one is the scalar reward of its image alone
    for j in range(3):
        r = tcr.blip_caption_reward(port, torch.from_numpy(images[j:j + 1]), ids[j:j + 1],
                                    mask[j:j + 1], labels[j:j + 1])
        assert abs(float(r) - float(got[j])) <= 1e-6


def test_cli_tiny(tmp_path):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a red car\na blue bird\na cat\n")
    out = tmp_path / "res.jsonl"
    res = teval.main(["--prompt-path", str(prompts), "--out", str(out), "--tiny",
                      "--device", "cpu", "--num-inference-steps", "3", "--resolution", "64",
                      "--batch-size", "2"])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(lines) == 4 and lines[:3] == res["rows"] and lines[-1] == res["summary"]
    assert {"prompt", "blip_reward", "bvqa_binding", "bvqa_questions",
            "bvqa_p_yes"} <= set(lines[0])
    assert lines[0]["bvqa_questions"], "no question for 'a red car'"
    assert all(0.0 <= p <= 1.0 for line in lines[:3] for p in line["bvqa_p_yes"])
    assert lines[-1]["n"] == 3
    assert np.isfinite(lines[-1]["mean_blip_reward"])
    assert 0.0 <= lines[-1]["mean_bvqa_binding"] <= 1.0
    assert set(res["seconds"]) == {"generate", "decode", "reward", "bvqa"}
    assert all(v > 0 for v in res["seconds"].values())


def test_full_size_gates_skip_without_building(tmp_path, monkeypatch, capsys):
    def no_build(*args, **kwargs):
        raise AssertionError("a model was built")

    monkeypatch.setattr(tpipe.DiffusionPipeline, "__init__", no_build)
    monkeypatch.setattr(tvqa, "make_blip_vqa", no_build)
    prompts = tmp_path / "p.txt"
    prompts.write_text("a red car\n")
    res = teval.main(["--prompt-path", str(prompts), "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert any(line.get("bvqa_binding") == "SKIPPED" for line in lines)
    assert any(line.get("blip_reward") == "SKIPPED" for line in lines)
    assert res["rows"] == [] and res["summary"] == {"n": 0}
    # real VQA weights need their vocabulary
    with pytest.raises(SystemExit, match="--vqa-tokenizer-vocab"):
        teval.main(["--prompt-path", str(prompts), "--device", "cpu", "--metric",
                    "bvqa_binding", "--vqa-model-path", str(tmp_path)])
