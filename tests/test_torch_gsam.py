"""The port's Grounded-SAM stack (comat_tpu_torch/ops/deformable_attention.py,
segmentation/{swin,gdino,fastsam,grounded_sam}.py) against the JAX
package, in fp32 on the CPU at the tiny geometries.

The same weights (the JAX modules' variables, filled from numpy through
`jax.eval_shape` and carried over by `weights.from_jax_params`) and the
same numpy inputs on both sides; the JAX forwards of the module tests
run in one jitted call, the JAX segmenter's in its own two. Tolerances:
- deformable attention within 1e-5 absolute (values of order one);
- Swin features (72^2, maps that 4 does not divide), GroundingDINO boxes
  and token logits (conv and swin backbones) and FastSAM heads and protos
  within 1e-4 of each output's max abs: fp32 stacks of GEMMs, norms and
  convs summed in other orders;
- the host helpers (`build_text_masks`, `ground_nouns`,
  `decode_predictions`, `_nms`, `box_prompt_masks`) exactly, on the same
  numpy inputs;
- the GroundingDINO resize (64^2 -> 100^2, a ratio that is not an
  integer) within 1e-5 of jax.image.resize;
- `GroundedSAMSegmenter.batch` masks exactly equal to JAX's batch and to
  the port's per-image calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu.ops.deformable_attention import ms_deformable_attention as jmsda
from comat_tpu.segmentation import fastsam as jfs
from comat_tpu.segmentation import gdino as jgd
from comat_tpu.segmentation.grounded_sam import GroundedSAMSegmenter as JSegmenter
from comat_tpu.segmentation.swin import SwinBackbone as JSwin
from comat_tpu.segmentation.swin import SwinConfig as JSwinConfig
from comat_tpu_torch.ops.deformable_attention import ms_deformable_attention
from comat_tpu_torch.segmentation import fastsam as tfs
from comat_tpu_torch.segmentation import gdino as tgd
from comat_tpu_torch.segmentation.grounded_sam import GroundedSAMSegmenter, gdino_input
from comat_tpu_torch.segmentation.swin import SwinBackbone, SwinConfig
from comat_tpu_torch.weights import from_jax_params

NOUNS = [["car", "bird"], [], ["red cat"]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under xdist several workers share the cores: one intra-op thread
    per worker keeps their torch work from oversubscribing them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seeded_variables(init, *args, seed=0):
    """A JAX module's variables filled from numpy without running its
    initialiser: kernels N(0, 1/fan_in), scales and running variances
    1 + 0.1|N|, other vectors 0.1 N."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, *args)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return np.asarray(rng.standard_normal(s.shape) / np.sqrt(fan_in), np.float32)
        if name in ("scale", "var"):
            return np.asarray(1 + 0.1 * np.abs(rng.standard_normal(s.shape)), np.float32)
        return np.asarray(0.1 * rng.standard_normal(s.shape), np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _text(B, T, seed):
    """Token ids in "<cls> a b . c d . <sep>" form with their masks."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 900, (B, T)).astype(np.int32)
    ids[:, 0], ids[:, 4], ids[:, 8] = 101, 5, 5
    ids[:, 9] = 102
    mask = np.zeros((B, T), bool)
    mask[:, :10] = True
    mask[-1, 6:] = False
    self_mask, pos = jgd.build_text_masks(ids, (101, 102, 5))
    return ids, mask, self_mask, pos


@pytest.fixture(scope="module")
def case():
    """The JAX forwards of the module tests, in one jitted call."""
    rng = np.random.default_rng(0)
    cfg_c, cfg_s = jgd.GDinoConfig.tiny(), jgd.GDinoConfig.tiny_swin()
    key = jax.random.PRNGKey(0)
    img64 = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    img72 = rng.uniform(-1, 1, (1, 72, 72, 3)).astype(np.float32)
    ids, mask, self_mask, pos = _text(2, cfg_c.max_text_len, 1)
    models = {"gd_conv": jgd.GroundingDetector(cfg_c), "gd_swin": jgd.GroundingDetector(cfg_s),
              "sam": jfs.YoloV8Seg(jfs.YoloSegConfig.tiny()),
              "swin": JSwin(JSwinConfig.tiny_test())}
    text = (ids, mask, self_mask, pos)
    args = {"gd_conv": (img64,) + text, "gd_swin": (img64,) + text, "sam": (img64,),
            "swin": (img72,)}
    variables = {k: _seeded_variables(m.init, key, *args[k], seed=i)
                 for i, (k, m) in enumerate(models.items())}
    # deformable attention: 3 levels, points partly outside the maps
    shapes = ((8, 8), (4, 4), (2, 2))
    S = sum(h * w for h, w in shapes)
    msda = (rng.standard_normal((2, S, 2, 8)).astype(np.float32),
            rng.uniform(-0.1, 1.1, (2, 5, 2, 3, 2, 2)).astype(np.float32),
            rng.dirichlet(np.ones(6), (2, 5, 2)).reshape(2, 5, 2, 3, 2).astype(np.float32))

    @jax.jit
    def run(variables, args, msda):
        out = {k: models[k].apply(variables[k], *args[k]) for k in models}
        out["msda"] = jmsda(msda[0], shapes, msda[1], msda[2])
        return out

    out = jax.tree_util.tree_map(np.asarray, run(variables, args, msda))
    return dict(models=models, variables=variables, args=args, out=out, msda=msda,
                shapes=shapes)


def _torch_args(args):
    return [torch.from_numpy(np.asarray(a)) for a in args]


def test_deformable_attention_matches_jax(case):
    value, locs, w = (torch.from_numpy(a) for a in case["msda"])
    got = ms_deformable_attention(value, case["shapes"], locs, w)
    assert got.shape == (2, 5, 16)
    np.testing.assert_allclose(got.numpy(), case["out"]["msda"], atol=1e-5, rtol=0)


def test_swin_features_match_jax(case):
    model = SwinBackbone(SwinConfig.tiny_test()).eval()
    sd = from_jax_params({"gdino": {"params": {"swin": case["variables"]["swin"]["params"]}}})
    model.load_state_dict({k[len("backbone.0."):]: v for k, v in sd["gdino"].items()})
    with torch.no_grad():
        got = model(*_torch_args(case["args"]["swin"]))
    want = case["out"]["swin"]
    assert [tuple(g.shape) for g in got] == [(1, 9, 9, 32), (1, 5, 5, 64), (1, 3, 3, 128)]
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < 1e-4


@pytest.mark.parametrize("which", ["gd_conv", "gd_swin"])
def test_grounding_detector_matches_jax(case, which):
    cfg = tgd.GDinoConfig.tiny() if which == "gd_conv" else tgd.GDinoConfig.tiny_swin()
    model = tgd.GroundingDetector(cfg).eval()
    model.load_state_dict(from_jax_params({"gdino": case["variables"][which]})["gdino"])
    with torch.no_grad():
        boxes, logits = model(*_torch_args(case["args"][which]))
    want_boxes, want_logits = case["out"][which]
    assert boxes.shape == (2, cfg.num_queries, 4)
    assert logits.shape == (2, cfg.num_queries, cfg.max_text_len)
    assert _rel(boxes.numpy(), want_boxes) < 1e-4
    live = want_logits > -1e29           # the masked tokens hold -1e30 on both sides
    np.testing.assert_array_equal(logits.numpy() > -1e29, live)
    assert _rel(logits.numpy()[live], want_logits[live]) < 1e-4


def test_fastsam_heads_and_protos_match_jax(case):
    model = tfs.YoloV8Seg(tfs.YoloSegConfig.tiny()).eval()
    model.load_state_dict(from_jax_params({"fastsam": case["variables"]["sam"]})["fastsam"])
    with torch.no_grad():
        outs, protos = model(*_torch_args(case["args"]["sam"]))
    want_outs, want_protos = case["out"]["sam"]
    assert protos.shape == want_protos.shape == (2, 16, 16, 8)
    assert _rel(protos.numpy(), want_protos) < 1e-4
    for o, w in zip(outs, want_outs):
        for k in ("box", "cls", "mc"):
            assert o[k].shape == w[k].shape
            assert _rel(o[k].numpy(), w[k]) < 1e-4


def test_build_text_masks_and_ground_nouns_equal_jax():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 8, (3, 12))
    for special in ([5, 7], [], [0, 1, 2]):
        want = jgd.build_text_masks(ids, special)
        got = tgd.build_text_masks(ids, special)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    boxes = rng.uniform(0, 1, (30, 4)).astype(np.float32)
    logits = (rng.standard_normal((30, 10)) * 3).astype(np.float32)
    logits[:, 8:] = -1e30
    spans = [(0, 2), (3, 4), (5, 8), (9, 9)]
    for thr in ((0.3, 0.25), (0.9, 0.5), (0.0, 0.0)):
        want = jgd.ground_nouns(boxes, logits, spans, *thr)
        got = tgd.ground_nouns(boxes, logits, spans, *thr)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.stack(got[k]), np.stack(want[k]))
    np.testing.assert_array_equal(tgd.cxcywh_to_xyxy(boxes, 64, 48),
                                  jgd.cxcywh_to_xyxy(boxes, 64, 48))


def _heads(rng, B=2, H=64, nm=8, reg=4):
    outs = []
    for lvl in range(3):
        h = H // (8 * 2 ** lvl)
        outs.append({"box": rng.standard_normal((B, h, h, 4 * reg)).astype(np.float32) * 2,
                     "cls": rng.standard_normal((B, h, h, 1)).astype(np.float32),
                     "mc": rng.standard_normal((B, h, h, nm)).astype(np.float32)})
    return outs, rng.standard_normal((B, H // 4, H // 4, nm)).astype(np.float32)


def test_host_decode_equals_jax():
    rng = np.random.default_rng(4)
    outs, protos = _heads(rng)
    want = jfs.decode_predictions(outs, protos, jfs.YoloSegConfig.tiny())
    got = tfs.decode_predictions(outs, protos, tfs.YoloSegConfig.tiny())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(w["boxes"]) > 1
        for k in ("boxes", "scores", "masks"):
            np.testing.assert_array_equal(g[k], w[k])
    boxes = rng.uniform(0, 50, (40, 4))
    boxes[:, 2:] += boxes[:, :2]
    boxes[5] = boxes[3]                         # a duplicate box, IoU 1
    scores = rng.uniform(0, 1, 40)
    for iou in (0.1, 0.5, 0.9):
        np.testing.assert_array_equal(tfs._nms(boxes, scores, iou), jfs._nms(boxes, scores, iou))
    # box prompts at proto 16^2 -> image 40 x 56 (ratios 2.5 and 3.5)
    for res_w, res_g in zip(want, got):
        for q in ([3.2, 5.0, 30.7, 22.1], [0, 0, 56, 40], [10.0, 10.0, 10.4, 10.4],
                  [50.0, 30.0, 60.0, 45.0], [-5.0, -5.0, 1.0, 2.0]):
            w = jfs.box_prompt_masks(res_w, q, (40, 56))
            g = tfs.box_prompt_masks(res_g, q, (40, 56))
            assert g.shape == (40, 56) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(
                tfs.box_prompt_masks({"masks": res_g["masks"]}, q, (40, 56)), w)


def test_gdino_resize_matches_jax_at_a_fractional_ratio():
    img = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = (jax.image.resize(jnp.asarray(img), (2, 100, 100, 3), method="bilinear")
            - jnp.asarray([0.485, 0.456, 0.406])) / jnp.asarray([0.229, 0.224, 0.225])
    got = gdino_input(torch.from_numpy(img), 100)
    assert got.shape == (2, 100, 100, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(gdino_input(torch.from_numpy(img), 64).numpy(),
                                  gdino_input(torch.from_numpy(img), None).numpy())


def test_segmenter_batch_equals_jax_and_per_image(case):
    """Thresholds 0 (the weights are random): every box grounds every noun,
    so each noun's mask is the union of many box prompts."""
    imgs = case["args"]["sam"][0]
    imgs = np.concatenate([imgs, imgs[:1, ::-1]])           # 3 images
    kw = dict(box_threshold=0.0, text_threshold=0.0)
    jseg = JSegmenter(sam_cfg=jfs.YoloSegConfig.tiny(), gdino_cfg=jgd.GDinoConfig.tiny(),
                      sam_params=case["variables"]["sam"],
                      gdino_params=case["variables"]["gd_conv"], image_size=64, **kw)
    want = jseg.batch(imgs, NOUNS)
    sd = from_jax_params({"gdino": case["variables"]["gd_conv"],
                          "fastsam": case["variables"]["sam"]})
    seg = GroundedSAMSegmenter(tfs.YoloSegConfig.tiny(), tgd.GDinoConfig.tiny(), device="cpu",
                               sam_params=sd["fastsam"], gdino_params=sd["gdino"], **kw)
    got = seg.batch(torch.from_numpy(imgs), NOUNS)
    assert [len(m) for m in got] == [len(m) for m in want] == [2, 0, 1]
    assert any(m.any() for ms in want for m in ms)
    for g_row, w_row, b in zip(got, want, range(3)):
        for g, w in zip(g_row, w_row):
            np.testing.assert_array_equal(g, w)
        for g, one in zip(g_row, seg(imgs[b], NOUNS[b])):
            np.testing.assert_array_equal(g, one)
    assert seg(imgs[1], []) == []


def test_seeded_fastsam_proposals_are_not_degenerate():
    """Drawn weights with BatchNorm statistics from a drawn image: the
    heads' logits keep their scale, so the decode keeps proposals whose
    masks are neither empty nor full."""
    seg = GroundedSAMSegmenter(tfs.YoloSegConfig.tiny(), tgd.GDinoConfig.tiny(), device="cpu",
                               seed=7)
    bn = seg.sam.model["2"].cv2.bn
    assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    img = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        outs, protos = seg.sam(img)
    assert float(outs[0]["cls"].std()) > 0.1 and float(protos.std()) > 0.1
    props = tfs.decode_predictions(outs, protos, seg.sam_cfg)
    cover = [float(m.mean()) for p in props for m in p["masks"]]
    assert cover and 0.0 < np.mean(cover) < 1.0
