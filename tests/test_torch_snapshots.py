"""The port's snapshot loaders (comat_tpu_torch/models/hf_import.py,
training/checkpoints.py `load_safetensors`) against the JAX package's, on
synthetic diffusers snapshots at tiny geometry on the CPU.

Each snapshot is written with JAX's own exporter
(`comat_tpu/tools/parity.py::export_hf_tensors` with `_unet_hf_name`,
`_vae_hf_name` and `_clip_hf_name`, as tests/test_synthetic_snapshots.py
writes them) from a parameter tree filled from numpy through
`jax.eval_shape` (JAX's eager init takes a minute), then loaded by JAX's
`load_sd_params` and by the port's `load_sd_state`:

- every port tensor equals `weights.from_jax_params` of the JAX-loaded
  tree exactly, SD1.5 and SDXL (`text_encoder_2` with its
  `text_projection`, the UNet's `add_embedding`) as cases;
- the text encodings, one guided UNet call (CFG 7.5) and one decode on
  both sides, in fp32, agree within 1e-5 of each output's max abs (one
  jitted JAX program for both families);
- file sets: fp16 and BF16 files (read exactly, fp16 as JAX reads it);
  a sharded folder with its index; an fp16 variant beside the
  non-variant file (the port reads the non-variant file and equals JAX,
  which reads both, the non-variant one last); the VAE's old attention
  names (`query`, `key`, `value`, `proj_attn`, one stored as a 1x1 conv),
  which the port renames as diffusers does while JAX keeps the
  destination's values (pinned); `position_ids` dropped; an empty folder,
  a missing shard and two variant sets without a non-variant one raise;
- the memory-mapped reader against the old whole-file reader's results on
  every dtype it keeps, a checkpoint written by `save_safetensors` bit for
  bit.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file
from safetensors.torch import save_file as save_torch_file

from comat_tpu.diffusion.guidance import make_cfg_eps_model as jcfg_eps
from comat_tpu.models import pipeline as jpipe
from comat_tpu.models.hf_import import (
    _clip_hf_name,
    _unet_hf_name,
    _vae_hf_name,
    load_sd_params,
)
from comat_tpu.text.tokenizer import HashTokenizer
from comat_tpu.tools.parity import export_hf_tensors
from comat_tpu_torch.diffusion.guidance import make_cfg_eps_model
from comat_tpu_torch.models import hf_import as thf
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.training.checkpoints import load_safetensors, save_safetensors
from comat_tpu_torch.weights import from_jax_params

FAMILIES = ("sd_1_5", "sdxl")
RES, RANK, T = 64, 4, 481
TOL = 1e-5
PROMPTS = ["a red car and a blue bird", "two green cats on a mat"]
TOWERS = {"unet": ("unet", _unet_hf_name, "diffusion_pytorch_model"),
          "vae": ("vae", _vae_hf_name, "diffusion_pytorch_model"),
          "text": ("text_encoder", _clip_hf_name, "model"),
          "text2": ("text_encoder_2", _clip_hf_name, "model")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run in parallel worker processes (pytest-xdist);
    one intra-op thread per worker keeps their torch work from
    oversubscribing the cores, which slows every worker many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seeded_params(init, *args, seed=0):
    """A JAX initialiser's parameter tree filled from numpy without running
    it: kernels N(0, 1/fan_in), norm scales 1, other vectors N(0, 0.1)
    (so that a bias that failed to load shows), `lora_b` N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, *args)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "lora_b":
            return np.asarray(0.1 * rng.standard_normal(s.shape), s.dtype)
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return np.asarray(rng.standard_normal(s.shape) / np.sqrt(fan_in), s.dtype)
        if name == "scale":
            return np.ones(s.shape, s.dtype)
        return np.asarray(0.1 * rng.standard_normal(s.shape), s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _hf_tensors(params, tower):
    """A tower's tensors in diffusers' layout. JAX's exporter writes the
    GEGLU bias as (2, 4 * dim), a layout its reader takes as well;
    diffusers' is flat."""
    out = export_hf_tensors(params[tower], TOWERS[tower][1])
    return {k: v.reshape(-1) if k.endswith("ff.net.0.proj.bias") else v
            for k, v in out.items()}


def _write(root, params, dtype=np.float32):
    """A diffusers snapshot of `params`' towers, one file each."""
    for tower, (sub, _, stem) in TOWERS.items():
        if tower in params:
            d = root / sub
            d.mkdir(parents=True, exist_ok=True)
            save_file({k: v.astype(dtype) for k, v in _hf_tensors(params, tower).items()},
                      str(d / f"{stem}.safetensors"))
    return root


def _with_projection(cfg):
    """SDXL's tiny second tower with bigG's `text_projection` (32 -> 32,
    so that the added embedding keeps its width)."""
    if cfg.text2 is None:
        return cfg
    return dataclasses.replace(cfg, text2=dataclasses.replace(cfg.text2, projection_dim=32))


def _jax_pipe(family):
    pcfg = _with_projection(jpipe.make_pipeline_config(family, lora_rank=RANK,
                                                       resolution=RES, tiny=True))
    return pcfg, jpipe.DiffusionPipeline(pcfg)


def _port_pipe(family, seed=5):
    cfg = _with_projection(tpipe.make_pipeline_config(family, lora_rank=RANK,
                                                      resolution=RES, tiny=True))
    return tpipe.DiffusionPipeline(cfg, device="cpu", seed=seed)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Per family: the written tree, the JAX-loaded tree (over another
    seeded tree), the snapshot, and the JAX side's encodings, guided eps
    and decode from the loaded tree (one jitted program)."""
    jax.config.update("jax_default_matmul_precision", "highest")
    root = tmp_path_factory.mktemp("snapshots")
    rng = np.random.default_rng(3)
    tok, tok2 = HashTokenizer(1000), HashTokenizer(1000, pad_token_id=0)
    enc, null = tok(PROMPTS), tok([""] * 2)
    inputs = {"ids": enc["input_ids"], "eos": enc["eos_positions"],
              "null_ids": null["input_ids"], "ids2": tok2(PROMPTS)["input_ids"],
              "null2": tok2([""] * 2)["input_ids"],
              "x": rng.standard_normal((2, RES // 8, RES // 8, 4)).astype(np.float32),
              "z": rng.standard_normal((1, RES // 8, RES // 8, 4)).astype(np.float32)}
    fams, pipes = {}, {}
    for family in FAMILIES:
        pcfg, pipe = _jax_pipe(family)
        src = _seeded_params(pipe.init_params, jax.random.PRNGKey(0), seed=1)
        dest = _seeded_params(pipe.init_params, jax.random.PRNGKey(0), seed=2)
        snap = _write(root / family, src)
        loaded = _np_tree(load_sd_params(str(snap), dest, pcfg))
        fams[family] = dict(src=src, dest=dest, loaded=loaded, snap=snap, pcfg=pcfg)
        pipes[family] = pipe

    @jax.jit
    def jax_side(trees, ids, eos, null_ids, ids2, null2, x, z):
        out = {}
        for family, params in trees.items():
            pipe = pipes[family]
            xl = pipe.cfg.is_sdxl
            e = pipe.encode_prompt(params, ids, eos, ids2 if xl else None)
            n = pipe.encode_prompt(params, null_ids, None, null2 if xl else None)
            added = pipe.sdxl_added_cond(e.pooled, 2) if xl else None
            null_added = pipe.sdxl_added_cond(n.pooled, 2) if xl else None
            eps_model = jcfg_eps(
                lambda lat, t, ctx, ac, cap: pipe.unet_apply(params, lat, t, ctx, ac, cap),
                e.context, n.context, 7.5, 0.0, added, null_added,
                capture_dtype=jnp.float32)
            out[family] = {"context": e.context, "null_context": n.context,
                           "eps": eps_model(x, jnp.asarray(T), False)[0],
                           "image": pipe.decode_image(params, z)}
            if xl:
                out[family]["pooled"] = e.pooled
        return out

    out = _np_tree(jax_side({f: v["loaded"] for f, v in fams.items()},
                            *(jnp.asarray(inputs[k]) for k in
                              ("ids", "eos", "null_ids", "ids2", "null2", "x", "z"))))
    for family in FAMILIES:
        fams[family]["out"] = out[family]
    return fams, inputs


@pytest.mark.parametrize("family", FAMILIES)
def test_loaded_tensors_equal_jax_loaded_tree(case, family):
    fam = case[0][family]
    pipe = _port_pipe(family)
    reports = thf.load_sd_state(str(fam["snap"]), pipe)
    towers = ("unet", "vae", "text", "text2") if family == "sdxl" else ("unet", "vae", "text")
    assert set(reports) == set(towers)
    want = from_jax_params(fam["loaded"])
    for tower in towers:
        r = reports[tower]
        assert r.missing == [] and r.unused == [], (tower, r.missing[:3], r.unused[:3])
        got = getattr(pipe, tower).state_dict()
        names = [n for n in got if "lora_" not in n]
        assert names and set(names) == {n for n in want[tower] if "lora_" not in n}
        for n in names:
            assert torch.equal(got[n], want[tower][n]), (tower, n)
    if family == "sdxl":
        assert "text_projection.weight" in pipe.text2.state_dict()
        assert "add_embedding.linear_1.weight" in pipe.unet.state_dict()
    # the loaded values are the written ones, not the destination's
    src = from_jax_params(_np_tree(fam["src"]))["unet"]
    assert torch.equal(pipe.unet.state_dict()["conv_in.weight"], src["conv_in.weight"])


@pytest.mark.parametrize("family", FAMILIES)
def test_guided_unet_call_and_decode_match_jax(case, family):
    fams, inputs = case
    fam = fams[family]
    pipe = _port_pipe(family)
    thf.load_sd_state(str(fam["snap"]), pipe)
    # the LoRA factors, which a base snapshot does not carry, as JAX's
    # destination tree holds them
    lora = {n: t for n, t in from_jax_params(fam["loaded"])["unet"].items() if "lora_" in n}
    pipe.unet.load_state_dict(lora, strict=False)
    xl = pipe.cfg.is_sdxl
    with torch.no_grad():
        e = pipe.encode_prompt(inputs["ids"], inputs["eos"],
                               input_ids2=inputs["ids2"] if xl else None)
        n = pipe.encode_prompt(inputs["null_ids"], None,
                               input_ids2=inputs["null2"] if xl else None)
        added = pipe.sdxl_added_cond(e.pooled, 2) if xl else None
        null_added = pipe.sdxl_added_cond(n.pooled, 2) if xl else None
        eps = make_cfg_eps_model(
            lambda lat, t, ctx, *ac: pipe.unet_apply(lat, t, ctx, *ac), e.context,
            n.context, 7.5, 0.0, added, null_added)(torch.from_numpy(inputs["x"]), T)
        image = pipe.decode_image(torch.from_numpy(inputs["z"]))
    want = fam["out"]
    assert _rel(e.context, want["context"]) <= TOL
    assert _rel(n.context, want["null_context"]) <= TOL
    if xl:
        assert _rel(e.pooled, want["pooled"]) <= TOL
    assert eps.shape == want["eps"].shape and _rel(eps, want["eps"]) <= TOL
    assert image.shape == want["image"].shape and _rel(image, want["image"]) <= TOL


def _copy_snapshot(fam, root, towers=("unet", "vae", "text")):
    """The SD1.5 source tree's towers written anew under `root`."""
    return _write(root, {t: fam["src"][t] for t in towers})


def test_fp16_and_bf16_files_load_exactly(case, tmp_path):
    """An fp16 UNet file and a BF16 VAE file into fp32 towers: the fp16
    values widened exactly, as JAX's `astype` does; BF16 (which JAX's
    numpy reader does not take) widened exactly too."""
    fam = case[0]["sd_1_5"]
    snap = _copy_snapshot(fam, tmp_path, towers=("text",))
    unet = {k: v.astype(np.float16) for k, v in _hf_tensors(fam["src"], "unet").items()}
    (snap / "unet").mkdir()
    save_file(unet, str(snap / "unet" / "diffusion_pytorch_model.fp16.safetensors"))
    vae = {k: torch.from_numpy(v).to(torch.bfloat16)
           for k, v in _hf_tensors(fam["src"], "vae").items()}
    (snap / "vae").mkdir()
    save_torch_file(vae, str(snap / "vae" / "diffusion_pytorch_model.safetensors"))
    jloaded = _np_tree(load_sd_params(str(snap), {k: v for k, v in fam["dest"].items()
                                                  if k != "vae"}, fam["pcfg"]))
    pipe = _port_pipe("sd_1_5")
    reports = thf.load_sd_state(str(snap), pipe)
    assert all(not r.missing and not r.unused for r in reports.values())
    want = from_jax_params(jloaded)["unet"]
    got = pipe.unet.state_dict()
    for n, t in want.items():
        if "lora_" not in n:
            assert torch.equal(got[n], t), n
    assert not torch.equal(got["conv_in.weight"],
                           from_jax_params(_np_tree(fam["src"]))["unet"]["conv_in.weight"])
    vae_got = pipe.vae.state_dict()
    vae_want = thf.vae_from_diffusers({k: v.float() for k, v in vae.items()})
    assert set(vae_want) == {n for n in vae_got}
    for n, t in vae_want.items():
        assert torch.equal(vae_got[n], t), n


def test_sharded_folder_loads_as_jax(case, tmp_path):
    fam = case[0]["sd_1_5"]
    snap = _copy_snapshot(fam, tmp_path, towers=("vae", "text"))
    tensors = _hf_tensors(fam["src"], "unet")
    names = sorted(tensors)
    (snap / "unet").mkdir()
    weight_map = {}
    for i, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        fn = f"diffusion_pytorch_model-{i + 1:05d}-of-00002.safetensors"
        save_file({k: tensors[k] for k in part}, str(snap / "unet" / fn))
        weight_map.update({k: fn for k in part})
    with open(snap / "unet" / "diffusion_pytorch_model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    assert len(thf.safetensors_files(str(snap / "unet"))) == 2
    jloaded = _np_tree(load_sd_params(str(snap), fam["dest"], fam["pcfg"]))
    pipe = _port_pipe("sd_1_5")
    reports = thf.load_sd_state(str(snap), pipe)
    assert not reports["unet"].missing and not reports["unet"].unused
    want = from_jax_params(jloaded)["unet"]
    got = pipe.unet.state_dict()
    assert all(torch.equal(got[n], t) for n, t in want.items() if "lora_" not in n)
    # a shard gone: the set is refused, naming the folder
    os.remove(snap / "unet" / "diffusion_pytorch_model-00002-of-00002.safetensors")
    with pytest.raises(FileNotFoundError, match="2-shard set"):
        thf.load_sd_state(str(snap), _port_pipe("sd_1_5"))


def test_variant_beside_the_non_variant_file_reads_the_non_variant(case, tmp_path):
    """diffusion_pytorch_model.fp16.safetensors (other values) beside the
    non-variant file: the port reads the non-variant file alone and equals
    JAX, which reads both in sorted order, the non-variant one last."""
    fam = case[0]["sd_1_5"]
    snap = _copy_snapshot(fam, tmp_path)
    other = {k: v.astype(np.float16)
             for k, v in _hf_tensors(fam["dest"], "unet").items()}
    save_file(other, str(snap / "unet" / "diffusion_pytorch_model.fp16.safetensors"))
    assert [os.path.basename(p) for p in thf.safetensors_files(str(snap / "unet"))] == [
        "diffusion_pytorch_model.safetensors"]
    jloaded = _np_tree(load_sd_params(str(snap), fam["dest"], fam["pcfg"]))
    pipe = _port_pipe("sd_1_5")
    thf.load_sd_state(str(snap), pipe)
    want = from_jax_params(jloaded)["unet"]
    src = from_jax_params(_np_tree(fam["src"]))["unet"]
    got = pipe.unet.state_dict()
    for n, t in want.items():
        if "lora_" not in n:
            assert torch.equal(got[n], t) and torch.equal(got[n], src[n]), n
    # two variants and no non-variant set: refused, naming them
    os.rename(snap / "unet" / "diffusion_pytorch_model.safetensors",
              snap / "unet" / "diffusion_pytorch_model.ema.safetensors")
    with pytest.raises(ValueError, match=r"\['ema', 'fp16'\]"):
        thf.safetensors_files(str(snap / "unet"))


def test_old_vae_attention_names_load_as_diffusers_not_jax(case, tmp_path):
    """A VAE saved by older diffusers: the mid-block attention under
    `query`, `key`, `value`, `proj_attn`, the decoder's `query` stored as
    a 1x1 conv. The port renames them as diffusers does at load and holds
    the written values; JAX's mapper knows only the new names, so its tree
    keeps the destination's values there (and reports them missing). The
    port follows the reference, not JAX."""
    fam = case[0]["sd_1_5"]
    snap = _copy_snapshot(fam, tmp_path, towers=("unet", "text"))
    new = _hf_tensors(fam["src"], "vae")
    old = {}
    for k, v in new.items():
        for a, b in (("to_q", "query"), ("to_k", "key"), ("to_v", "value"),
                     ("to_out.0", "proj_attn")):
            k = k.replace(f".attentions.0.{a}.", f".attentions.0.{b}.")
        old[k] = v
    q = "decoder.mid_block.attentions.0.query.weight"
    old[q] = old[q][:, :, None, None]
    (snap / "vae").mkdir()
    save_file(old, str(snap / "vae" / "diffusion_pytorch_model.safetensors"))
    jloaded = _np_tree(load_sd_params(str(snap), fam["dest"], fam["pcfg"]))
    pipe = _port_pipe("sd_1_5")
    report = thf.load_sd_state(str(snap), pipe)["vae"]
    assert report.missing == [] and report.unused == []
    src = from_jax_params(_np_tree(fam["src"]))["vae"]
    dest = from_jax_params(_np_tree(fam["dest"]))["vae"]
    jax_got = from_jax_params(jloaded)["vae"]
    got = pipe.vae.state_dict()
    attn = [n for n in got if ".mid_block.attentions.0.to_" in n]
    assert len(attn) == 16
    for n in got:
        assert torch.equal(got[n], src[n]), n
        # JAX: the renamed tensors keep the destination's values
        assert torch.equal(jax_got[n], dest[n] if n in attn else src[n]), n


def test_position_ids_dropped_and_empty_folders_raise(case, tmp_path):
    fam = case[0]["sd_1_5"]
    snap = _copy_snapshot(fam, tmp_path)
    text = _hf_tensors(fam["src"], "text")
    text["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
    save_file(text, str(snap / "text_encoder" / "model.safetensors"))
    pipe = _port_pipe("sd_1_5")
    reports = thf.load_sd_state(str(snap), pipe)
    assert reports["text"].unused == [] and reports["text"].missing == []
    for sub in ("vae", "empty"):
        d = snap / sub
        for f in d.glob("*") if d.exists() else ():
            f.unlink()
        d.mkdir(exist_ok=True)
        (d / "diffusion_pytorch_model.bin").write_bytes(b"")   # .bin is not read
        with pytest.raises(FileNotFoundError, match=f"no .safetensors file in .*{sub}"):
            thf.load_safetensors_dir(str(d))
    with pytest.raises(FileNotFoundError, match="vae"):
        thf.load_sd_state(str(snap), pipe)
    # a tower whose folder is absent: every tensor reported missing
    import shutil

    shutil.rmtree(snap / "vae")
    reports = thf.load_sd_state(str(snap), pipe)
    assert len(reports["vae"].missing) == len(pipe.vae.state_dict())


def _whole_file_reader(path):
    """The earlier reader: the whole file read into memory at once."""
    import struct

    dtypes = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4"}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        a, b = info["data_offsets"]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(data[a:b], "<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(info["shape"])
        else:
            out[name] = np.frombuffer(data[a:b], dtypes[info["dtype"]]).reshape(info["shape"])
    return out


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16", "I64", "I32", "checkpoint"])
def test_memory_mapped_reader_reads_as_the_whole_file_reader(tmp_path, dtype):
    rng = np.random.default_rng(4)
    path = str(tmp_path / "t.safetensors")
    vals = {"a": rng.standard_normal((3, 5)), "b": rng.standard_normal((7,)),
            "c": rng.standard_normal((2, 1, 4))}
    if dtype == "checkpoint":
        save_safetensors(path, {k: v.astype(np.float32) for k, v in vals.items()})
    elif dtype == "BF16":
        save_torch_file({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in vals.items()},
                        path)
    else:
        np_dtype = {"F32": np.float32, "F16": np.float16, "I64": np.int64,
                    "I32": np.int32}[dtype]
        save_file({k: (v * 100).astype(np_dtype) for k, v in vals.items()}, path)
    got, want = load_safetensors(path), _whole_file_reader(path)
    assert set(got) == set(want) == set(vals)
    for k in vals:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
        if dtype != "BF16":
            assert isinstance(got[k], np.memmap)
