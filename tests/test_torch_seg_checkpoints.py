"""Loading the segmentation models' checkpoints into the port
(comat_tpu_torch/segmentation/checkpoints.py, gdino_import_hf.py,
weights.from_jax_params' "gdino" and "fastsam" trees), on the CPU at the
tiny geometries.

- Synthetic .pt / .pth files this test writes (a raw state dict, the
  {"model": ...} / {"state_dict": ...} wrappers, "module." prefixes,
  ultralytics' "model.model.{idx}" names, the buffers and extra tensors a
  release carries) load with `load_state_dict`, every tensor exactly; a
  tensor the file lacks is reported missing, one the module has no place
  for unused.
- The round trip: a synthetic IDEA / ultralytics state dict through JAX's
  importers (`load_gdino_params`, `load_fastsam_params`), then through
  `from_jax_params`, comes back equal to itself: the importers'
  transposes, q/k/v splits, patch-merge permutation and tap flip are
  inverted exactly.
- Where `transformers` is installed: a tiny HF GroundingDino renamed by
  the port (`hf_to_gdino_tensors`, and a safetensors snapshot of it read
  by the port's own reader) gives the outputs of the JAX import of it,
  within 1e-4 of each output's max abs (one JAX compile).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu.segmentation import fastsam as jfs
from comat_tpu.segmentation import gdino as jgd
from comat_tpu.segmentation.gdino_import import load_gdino_params
from comat_tpu.segmentation.weights_import import load_fastsam_params
from comat_tpu_torch.segmentation import checkpoints as seg_ckpt
from comat_tpu_torch.segmentation.fastsam import YoloSegConfig, YoloV8Seg
from comat_tpu_torch.segmentation.gdino import GDinoConfig, GroundingDetector
from comat_tpu_torch.segmentation.gdino_import_hf import (
    hf_to_gdino_tensors,
    load_gdino_hf_snapshot,
)
from comat_tpu_torch.training.checkpoints import load_safetensors, save_safetensors
from comat_tpu_torch.weights import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_state(module, seed):
    """The module's state dict with every tensor drawn (variances > 0)."""
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.rand(v.shape, generator=g) + 0.5 if k.endswith("running_var")
                else torch.randn(v.shape, generator=g))
            for k, v in module.state_dict().items()}


def _assert_holds(module, state):
    own = module.state_dict()
    assert own.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(own[k], v), k


def _ultralytics(state):
    return {"model." + k: v for k, v in state.items()}


@pytest.mark.parametrize("layout", ["raw", "model_wrapped", "state_dict_module"])
def test_fastsam_checkpoint_files_load(tmp_path, layout):
    model = YoloV8Seg(YoloSegConfig.tiny())
    state = _random_state(model, 0)
    extra = {"model.22.dfl.conv.weight": torch.arange(4.0).reshape(1, 4, 1, 1)}
    tracked = {"model.0.bn.num_batches_tracked": torch.tensor(7)}
    if layout == "raw":                  # a DetectionModel's own state dict
        payload = {**state, **extra, **tracked}
    elif layout == "model_wrapped":      # the raw file: "model.model.{idx}"
        payload = {"model": _ultralytics({**state, **extra, **tracked}), "epoch": 3}
    else:
        payload = {"state_dict": {f"module.{k}": v for k, v in _ultralytics(state).items()}}
    path = tmp_path / "FastSAM-x.pt"
    torch.save(payload, path)
    fresh = YoloV8Seg(YoloSegConfig.tiny())
    missing, unused = seg_ckpt.load_fastsam_checkpoint(str(path), fresh)
    assert missing == []
    assert unused == ([] if layout == "state_dict_module" else ["model.22.dfl.conv.weight"])
    _assert_holds(fresh, state)


def test_gdino_checkpoint_files_load_and_report(tmp_path):
    cfg = GDinoConfig.tiny_swin()
    state = _random_state(GroundingDetector(cfg), 1)
    derived = {"backbone.0.layers.0.blocks.0.attn.relative_position_index":
               torch.zeros(16, 16, dtype=torch.long),
               "bert.embeddings.position_ids": torch.arange(64)[None]}
    release = {**state, **derived, "transformer.enc_out_class_embed.bias": torch.zeros(1)}
    torch.save({"model": release, "optimizer": {}}, tmp_path / "release.pth")
    torch.save({f"module.{k}": v for k, v in state.items()}, tmp_path / "ddp.pth")
    for name, unused_want in (("release.pth", ["transformer.enc_out_class_embed.bias"]),
                              ("ddp.pth", [])):
        fresh = GroundingDetector(cfg)
        missing, unused = seg_ckpt.load_gdino_checkpoint(str(tmp_path / name), fresh)
        assert missing == [] and unused == unused_want
        _assert_holds(fresh, state)
    short = {k: v for k, v in state.items() if k != "feat_map.bias"}
    torch.save(short, tmp_path / "short.pth")
    missing, _ = seg_ckpt.load_gdino_checkpoint(str(tmp_path / "short.pth"),
                                                GroundingDetector(cfg))
    assert missing == ["feat_map.bias"]


def _zeros(init, *args):
    shapes = jax.eval_shape(init, *args)
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_from_jax_params_inverts_the_jax_importers():
    key = jax.random.PRNGKey(0)
    # GroundingDINO at the swin geometry: every tensor has an IDEA name
    jcfg = jgd.GDinoConfig.tiny_swin()
    T = jcfg.max_text_len
    gd_vars = _zeros(jgd.GroundingDetector(jcfg).init, key, jnp.zeros((1, 64, 64, 3)),
                     jnp.zeros((1, T), jnp.int32), jnp.ones((1, T), bool))
    state = _random_state(GroundingDetector(GDinoConfig.tiny_swin()), 2)
    loaded, missing = load_gdino_params({k: v.numpy() for k, v in state.items()}, gd_vars)
    assert missing == []
    back = from_jax_params({"gdino": _numpy(loaded)})["gdino"]
    assert back.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    # FastSAM: params and batch statistics, the proto's ConvTranspose
    fs_vars = _zeros(jfs.YoloV8Seg(jfs.YoloSegConfig.tiny()).init, key,
                     jnp.zeros((1, 64, 64, 3)))
    state = _random_state(YoloV8Seg(YoloSegConfig.tiny()), 3)
    loaded, missing = load_fastsam_params(
        {k: v.numpy() for k, v in _ultralytics(state).items()}, fs_vars)
    assert missing == []
    back = from_jax_params({"fastsam": _numpy(loaded)})["fastsam"]
    assert back.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(back[k], v), k


def test_safetensors_reader_reads_the_writer(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"a.weight": rng.standard_normal((3, 5)).astype(np.float32),
               "b": np.arange(7, dtype=np.float32)}
    save_safetensors(str(tmp_path / "t.safetensors"), tensors)
    got = load_safetensors(str(tmp_path / "t.safetensors"))
    assert got.keys() == tensors.keys()
    for k, v in tensors.items():
        np.testing.assert_array_equal(got[k], v)


def test_hf_snapshot_matches_the_jax_import(tmp_path):
    pytest.importorskip("transformers.models.grounding_dino.modeling_grounding_dino")
    from comat_tpu.segmentation.gdino_import_hf import convert_gdino_from_hf
    from comat_tpu.tools.parity import _build_hf_gdino_tiny

    hf = _build_hf_gdino_tiny()
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    ids = np.array([[101, 5, 200, 300, 1012, 5, 400, 500, 1012, 102]], np.int64)
    T = ids.shape[1]
    mask = np.ones((1, T), bool)
    self_mask, pos = jgd.build_text_masks(ids, (101, 102, 1012))
    image = (np.random.default_rng(0).standard_normal((1, 128, 128, 3)) * 0.5) \
        .astype(np.float32)
    jcfg = dataclasses.replace(jgd.GDinoConfig.tiny_swin(), text_vocab=2000)
    jmodel = jgd.GroundingDetector(jcfg)
    args = (image, ids.astype(np.int32), mask, self_mask, pos)
    params, missing = convert_gdino_from_hf(_zeros(jmodel.init, jax.random.PRNGKey(0), *args),
                                            sd)
    assert missing == []
    want_boxes, want_logits = (np.asarray(o) for o in jax.jit(jmodel.apply)(params, *args))

    cfg = dataclasses.replace(GDinoConfig.tiny_swin(), text_vocab=2000)
    model = GroundingDetector(cfg).eval()
    missing, unused = seg_ckpt.load_into(
        model, {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in hf_to_gdino_tensors(sd).items()})
    assert missing == [] and unused == []
    # the same weights from a safetensors snapshot, read by the port
    save_safetensors(str(tmp_path / "model.safetensors"), sd)
    snap = GroundingDetector(cfg).eval()
    assert load_gdino_hf_snapshot(snap, str(tmp_path)) == ([], [])
    _assert_holds(snap, model.state_dict())
    with torch.no_grad():
        boxes, logits = model(*(torch.from_numpy(np.asarray(a)) for a in args))
    rel = lambda g, w: float(np.abs(g - w).max() / np.abs(w).max())  # noqa: E731
    assert rel(boxes.numpy(), want_boxes) < 1e-4
    live = want_logits > -1e29
    np.testing.assert_array_equal(logits.numpy() > -1e29, live)
    assert rel(logits.numpy()[live], want_logits[live]) < 1e-4
