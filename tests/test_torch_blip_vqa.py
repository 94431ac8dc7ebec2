"""The port's BLIP-VQA (`models/blip_vqa.py`) against the JAX package's, on
the CPU at tiny geometry in fp32.

- A tiny transformers `BlipForQuestionAnswering`, saved with
  `safe_serialization=True` (the tied LM head dropped, as real snapshots
  drop it), is loaded by JAX's `load_blip_vqa_params` and by the port's
  `load_blip_vqa_state`: nothing missing, every port tensor equal to
  `weights.from_jax_params` of JAX's tree, and P(yes) and both answer
  log-likelihoods within 1e-5, with a padded question row and a padded
  answer label.
- `encode_fixed` and `build_answer_batch` equal JAX's (hash and WordPiece
  tokenizers).
- `from_jax_params` round trip: a JAX tree into the port and back through
  JAX's own name map gives the tree again.
- The captioner's text layer with no `cross_mask` is JAX's
  `BLIPTextLayer` with none, and with one it is JAX's with the same mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from comat_tpu.config import BLIPConfig as JBLIPConfig
from comat_tpu.models import blip_vqa as jvqa
from comat_tpu.models.blip import BLIPTextLayer as JTextLayer
from comat_tpu.models.hf_import import _blip_vqa_hf_name, convert_tree, load_blip_vqa_params
from comat_tpu.text.tokenizer import BertWordPieceTokenizer as JBert
from comat_tpu.text.tokenizer import HashTokenizer as JHash
from comat_tpu_torch.config import BLIPConfig
from comat_tpu_torch.models import blip_vqa as tvqa
from comat_tpu_torch.models.blip import BlipTextLayer
from comat_tpu_torch.models.hf_import import load_blip_vqa_state
from comat_tpu_torch.text.tokenizer import BertWordPieceTokenizer, HashTokenizer
from comat_tpu_torch.weights import from_jax_params

TOL = 1e-5
SQ, SA = 8, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per xdist worker, so that parallel test files do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    torch.set_num_threads(threads)


def _inputs():
    rng = np.random.default_rng(2)
    cfg = BLIPConfig.tiny()
    B, H = 3, cfg.image_size
    pix = rng.standard_normal((B, H, H, 3)).astype(np.float32)
    q_ids = rng.integers(4, cfg.vocab_size, (B, SQ)).astype(np.int32)
    q_mask = np.ones((B, SQ), np.int32)
    q_mask[1, 5:] = 0
    q_ids[1, 5:] = 0
    answers = []
    for _ in range(2):
        ids = rng.integers(4, cfg.vocab_size, (B, SA)).astype(np.int32)
        ids[:, 0] = cfg.bos_token_id
        labels = ids.copy()
        labels[2, 3:] = -100      # a padded answer position is not scored
        answers += [ids, labels]
    return pix, q_ids, q_mask, answers


def _jax_logliks(model, params, pix, q_ids, q_mask, answers):
    def f(m, pix, q, qm, ya, yl, na, nl):
        qs = m.encode_question(q, qm, m.vision(pix))
        return m.answer_loglik(qs, qm, ya, yl), m.answer_loglik(qs, qm, na, nl)

    args = [jnp.asarray(a) for a in (pix, q_ids, q_mask, *answers)]
    ll = model.apply(params, *args, method=f)
    p = model.apply(params, *args)
    return [np.asarray(x) for x in (*ll, p)]


def _port_logliks(vqa, pix, q_ids, q_mask, answers):
    args = [torch.from_numpy(np.asarray(a)) for a in (pix, q_ids, q_mask, *answers)]
    ll_yes, ll_no = vqa.answer_logliks(*args)
    return [x.numpy() for x in (ll_yes, ll_no, vqa.yes_probability(*args))]


def test_snapshot_loads_and_scores_as_jax(tmp_path):
    transformers = pytest.importorskip("transformers")
    vcfg = transformers.BlipVisionConfig(
        image_size=64, patch_size=16, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64)
    tcfg = transformers.BlipTextConfig(
        vocab_size=1000, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, encoder_hidden_size=32, max_position_embeddings=512,
        bos_token_id=1)
    torch.manual_seed(3)
    hf = transformers.BlipForQuestionAnswering(transformers.BlipConfig(
        text_config=tcfg.to_dict(), vision_config=vcfg.to_dict())).eval()
    with torch.no_grad():   # nonzero biases and norms, so that every name matters
        for p in hf.parameters():
            if p.dim() == 1:
                p.add_(0.05 * torch.randn_like(p))
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    head = "text_decoder.cls.predictions.decoder.weight"
    from safetensors.numpy import load_file

    assert head not in load_file(str(tmp_path / "model.safetensors"))

    jcfg = JBLIPConfig.tiny()
    model = jvqa.BLIPVQA(jcfg)
    pix, q_ids, q_mask, answers = _inputs()
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            *[jnp.asarray(a) for a in (pix, q_ids, q_mask, *answers)])
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jparams = load_blip_vqa_params(str(tmp_path), zeros)

    vqa = tvqa.make_blip_vqa(BLIPConfig.tiny(), device="cpu", seed=9)
    report = load_blip_vqa_state(str(tmp_path), vqa)
    assert report.missing == [] and report.unused == []
    want = from_jax_params({"blip_vqa": jax.tree_util.tree_map(np.asarray, jparams)})
    got = vqa.state_dict()
    assert set(want["blip_vqa"]) == set(got)
    for n, v in want["blip_vqa"].items():
        assert torch.equal(got[n], v), n
    # the restored head is the decoder's word embeddings, as HF ties them
    assert torch.equal(got[head], hf.state_dict()[head])

    j_yes, j_no, j_p = _jax_logliks(model, jparams, pix, q_ids, q_mask, answers)
    t_yes, t_no, t_p = _port_logliks(vqa, pix, q_ids, q_mask, answers)
    assert np.isfinite(j_p).all() and ((0 < j_p) & (j_p < 1)).all()
    np.testing.assert_allclose(t_yes, j_yes, atol=TOL, rtol=0)
    np.testing.assert_allclose(t_no, j_no, atol=TOL, rtol=0)
    np.testing.assert_allclose(t_p, j_p, atol=TOL, rtol=0)


def test_padded_question_keys_do_not_move_the_answer():
    """Changing the ids under a question's padding leaves its scores as
    they were: both towers mask the padded keys."""
    vqa = tvqa.make_blip_vqa(BLIPConfig.tiny(), device="cpu", seed=4)
    pix, q_ids, q_mask, answers = _inputs()
    before = _port_logliks(vqa, pix, q_ids, q_mask, answers)
    q_ids = q_ids.copy()
    q_ids[1, 5:] = 77
    after = _port_logliks(vqa, pix, q_ids, q_mask, answers)
    for b, a in zip(before, after):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("tokenizer", ["hash", "wordpiece"])
def test_encode_fixed_and_answer_batch_equal_jax(tmp_path, tokenizer):
    if tokenizer == "hash":
        jt, tt = JHash(1000), HashTokenizer(1000)
    else:
        vocab = tmp_path / "vocab.txt"
        vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "yes",
                                    "no", "red", "car", "blue", "bird", "?", "a"]) + "\n")
        jt, tt = JBert(str(vocab)), BertWordPieceTokenizer(str(vocab))
    questions = ["red car?", "a blue bird that is very far away and red?"]
    for length in (4, 16):
        j = jvqa.encode_fixed(jt, questions, length)
        t = tvqa.encode_fixed(tt, questions, length)
        for a, b in zip(j, t):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    for answer in ("yes", "no"):
        j = jvqa.build_answer_batch(jt, [answer], 3, 8, bos_token_id=30522)
        t = tvqa.build_answer_batch(tt, [answer], 3, 8, bos_token_id=30522)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(a, b)
        assert (t[0][:, 0] == 30522).all() and (t[1][:, 0] == t[0][:, 0]).all()


def test_from_jax_params_round_trip():
    """A JAX BLIPVQA tree through `from_jax_params` into the port, then back
    through JAX's own snapshot name map: the tree again, and the port
    scores as JAX on it."""
    jcfg = JBLIPConfig.tiny()
    model = jvqa.BLIPVQA(jcfg)
    pix, q_ids, q_mask, answers = _inputs()
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            *[jnp.asarray(a) for a in (pix, q_ids, q_mask, *answers)])
    rng = np.random.default_rng(5)
    tree = jax.tree_util.tree_map(
        lambda s: (0.2 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    sd = from_jax_params({"blip_vqa": tree})["blip_vqa"]
    vqa = tvqa.make_blip_vqa(BLIPConfig.tiny(), device="cpu", params=sd)
    zeros = jax.tree_util.tree_map(np.zeros_like, tree)
    back, missing = convert_tree(zeros, {n: v.numpy() for n, v in sd.items()},
                                 _blip_vqa_hf_name)
    assert not missing
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(path))
    j = _jax_logliks(model, tree, pix, q_ids, q_mask, answers)
    t = _port_logliks(vqa, pix, q_ids, q_mask, answers)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


@pytest.mark.parametrize("with_mask", [False, True])
def test_text_layer_cross_mask_as_jax(with_mask):
    """The captioner's layer (vision-wide keys) without a cross mask, as it
    runs in the reward, and with one, against JAX's BLIPTextLayer."""
    rng = np.random.default_rng(1)
    jcfg = JBLIPConfig.tiny()
    cfg = BLIPConfig.tiny()
    B, S, Sv = 2, 5, 7
    x = rng.standard_normal((B, S, cfg.text_hidden_size)).astype(np.float32)
    enc = rng.standard_normal((B, Sv, cfg.vision_hidden_size)).astype(np.float32)
    mask = np.tril(np.ones((S, S), bool))[None, None].repeat(B, 0)
    cross = None
    if with_mask:
        cross = np.ones((B, 1, 1, Sv), bool)
        cross[1, ..., 4:] = False
    layer = JTextLayer(jcfg)
    shapes = jax.eval_shape(layer.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(mask), jnp.asarray(enc))
    params = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    want = np.asarray(layer.apply(params, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(enc),
                                  None if cross is None else jnp.asarray(cross)))
    # the layer's leaves under a captioner tree's first text layer
    sd = from_jax_params({"blip": {"params": {"text_layers_0": params["params"]}}})["blip"]
    prefix = "text_decoder.bert.encoder.layer.0."
    port = BlipTextLayer(cfg)
    port.load_state_dict({n[len(prefix):]: v for n, v in sd.items()})
    assert port.crossattention.self.key.in_features == cfg.vision_hidden_size
    args = [torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(enc)]
    with torch.no_grad():
        got = port(*args) if cross is None else port(*args, torch.from_numpy(cross))
        if cross is None:   # an all-True mask changes nothing, bit for bit
            assert torch.equal(port(*args, torch.ones(B, 1, 1, Sv, dtype=torch.bool)), got)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
