"""The port's tensor parallelism (`comat_tpu_torch.parallel.tp`) against
JAX's rule and JAX's sharded step, at tiny geometry in fp32 on the CPU.

- `tp_plan` shards exactly the UNet tensors that JAX's `_spec_for` shards
  on the same trees (each JAX leaf found under its port name through
  `weights.from_jax_params`), the LoRA factors of the sharded layers
  beside them (JAX leaves LoRA replicated; the port shards B of a
  column-parallel layer and A of a row-parallel one), except where the
  attention's heads do not divide by the model axis: none at the tiny
  UNets' M = 2, SDXL's 10-head level at full width and M = 4.
- `apply_tp` at M = 2 (two processes over Gloo): a capture forward and
  the LoRA gradients of the sharded tiny SD1.5 and SDXL UNets equal the
  unsharded module's within 1e-5.
- A train step on a (2, 2) mesh (four processes: data parallel over 2,
  the UNet sharded over 2) against JAX's step on the same mesh with
  `tp_param_shardings` (tests/test_train_step.py's
  `test_train_step_dp_plus_tp_mesh`: SD1.5 tiny, 64^2, batch 4,
  total_step 10, K 3), and with the attribute-concentration capture
  (128^2, total_step 6, K 3, A 2), within the whole-step gates
  (`assert_step_matches`, TOL and GRAD_TOL 1e-3). One jitted JAX
  program holds both.
- W8A8 pass 1 on a sharded UNet raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from comat_tpu.config import BLIPConfig as JBLIPConfig
from comat_tpu.losses.caption_reward import build_caption_batch
from comat_tpu.models import pipeline as jpipe
from comat_tpu.models.blip import BLIPCaptioner as JBLIP
from comat_tpu.parallel import tp as jtp
from comat_tpu.parallel.mesh import make_mesh, replicate_tree, shard_batch
from comat_tpu.segmentation.interface import CenterPriorSegmenter, SegmenterHolder
from comat_tpu.text.tokenizer import HashTokenizer
from comat_tpu.training import attrcon as jattr
from comat_tpu.training import train_step as jts
from comat_tpu_torch.config import UNetConfig
from comat_tpu_torch.models.quant import quantize_unet
from comat_tpu_torch.models.unet import UNet2DConditionModel
from comat_tpu_torch.parallel import tp as ptp
from comat_tpu_torch.training import train_step as tts
from comat_tpu_torch.weights import from_jax_params
from torch_dist import run_ranks, step_rank, tp_unet_rank
from torch_step_parity import assert_step_matches, by_port_name, seeded_params

RANK = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_sharded_names(name, model_size):
    """The port names of the UNet leaves JAX's `_spec_for` shards."""
    pcfg = jpipe.make_pipeline_config(name, lora_rank=RANK, resolution=128, tiny=True)
    shapes = jax.eval_shape(jpipe.DiffusionPipeline(pcfg).init_params,
                            jax.random.PRNGKey(0))["unet"]
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    marked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [np.full(s.shape, i + 1, np.float32) for i, (_, s) in enumerate(leaves)])
    port = from_jax_params({"unet": marked})["unet"]
    by_leaf = {}
    for n, t in port.items():
        values = set(np.unique(t.numpy()).tolist())
        assert len(values) == 1, n
        by_leaf.setdefault(int(values.pop()) - 1, []).append(n)
    out = set()
    for i, (path, s) in enumerate(leaves):
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        if jtp._spec_for(keys, s.shape, model_size) != jtp.P():
            out.update(by_leaf[i])
    return out, set(port)


@pytest.mark.parametrize("name,cfg", [("sd_1_5", UNetConfig.tiny()),
                                      ("sdxl", UNetConfig.tiny_xl())])
def test_plan_shards_what_jax_shards(name, cfg):
    jax_names, all_names = _jax_sharded_names(name, 2)
    plan = ptp.unet_plan(UNet2DConditionModel(cfg, lora_rank=RANK, device="meta"), 2)
    base = {n for n in plan if "lora_" not in n}
    assert base == jax_names and base
    assert set(plan) <= all_names
    for n in set(plan) - base:      # LoRA: B of a column layer, A of a row one
        layer, leaf = n.rsplit(".", 1)
        assert f"{layer}.base.weight" in base
        assert (leaf == "lora_a") == layer.endswith("to_out.0"), n
    assert not [n for n in jax_names if n not in plan]   # no head-misaligned layer


def test_sdxl_at_four_keeps_its_ten_head_level_replicated():
    with torch.device("meta"):
        unet = UNet2DConditionModel(UNetConfig.sdxl(), lora_rank=RANK)
    plan2, plan4 = ptp.unet_plan(unet, 2), ptp.unet_plan(unet, 4)
    attn = {n for n in plan2 if ".attn" in n}
    dropped = attn - set(plan4)
    assert dropped and all(n.startswith(("down_blocks.1.", "up_blocks.1.")) for n in dropped)
    assert not any(n.startswith(("down_blocks.2.", "up_blocks.0.", "mid_block."))
                   for n in dropped)
    # the feed-forwards of that level still shard: JAX's rule has no heads there
    assert {n for n in plan2 if ".ff." in n} == {n for n in plan4 if ".ff." in n}


@pytest.mark.parametrize("config", ["sd15", "sdxl"])
def test_apply_tp_matches_the_unsharded_unet(config):
    out = run_ranks(tp_unet_rank, 2, {"config": config})
    for r in out:
        assert r["plan"] and r["n_maps"] > 0
        assert r["eps"] <= 1e-5 and r["maps"] <= 1e-5, (r["eps"], r["maps"])
        worst = max(r["grads"].values())
        assert worst <= 1e-5, worst


def test_int8_pass1_under_tp_raises():
    unet = UNet2DConditionModel(UNetConfig.tiny(), lora_rank=0)
    unet.tp_sharded = frozenset({"x"})
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1: int8 pass 1 under"):
        quantize_unet(unet)


# ---- the sharded step against JAX's ----

def _batch(prompts, res, attrcon):
    tok = HashTokenizer(1000)
    B = len(prompts)
    enc, null = tok(prompts, max_length=77), tok([""] * B, max_length=77)
    cap = build_caption_batch(tok, prompts)

    def pad(a, v):
        return np.pad(a, ((0, 0), (0, 24 - a.shape[1])), constant_values=v)

    batch = {"input_ids": enc["input_ids"], "eos_positions": enc["eos_positions"],
             "null_ids": null["input_ids"], "caption_ids": pad(cap["input_ids"], 0),
             "caption_mask": pad(cap["attention_mask"], 0),
             "caption_labels": pad(cap["labels"], -100)}
    if attrcon:
        holder = SegmenterHolder(CenterPriorSegmenter(), max_words=4)
        batch.update(jattr.attrcon_batch_fields(prompts, tok, holder, 77, resolution=res))
    return batch


CASES = {
    # tests/test_train_step.py::_build(4) and its TrainConfig
    "reward": dict(name="sd_1_5", res=64, prompts=["a red car and a blue bird",
                                                   "two cats on a mat"] * 2,
                   train=dict(total_step=10, K=3, resolution=64, learning_rate=1e-3)),
    "capture": dict(name="sd_1_5_attrcon", res=128,
                    prompts=["a red car and a blue bird", "two green cats on a mat",
                             "a blue bowl", "a yellow dog and a black cat"],
                    train=dict(total_step=6, K=3, resolution=128, attrcon=True,
                               attrcon_train_steps=2)),
}


@pytest.fixture(scope="module")
def jax_cases():
    jax.config.update("jax_default_matmul_precision", "highest")
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    inputs, fns, extra = {}, {}, {}
    for kind, c in CASES.items():
        pcfg = jpipe.make_pipeline_config(c["name"], lora_rank=RANK, resolution=c["res"],
                                          tiny=True)
        pipe = jpipe.DiffusionPipeline(pcfg)
        params = seeded_params(pipe.init_params, jax.random.PRNGKey(0), seed=0)
        batch = _batch(c["prompts"], c["res"], "attrcon" in c["train"])
        blip = JBLIP(JBLIPConfig.tiny())
        blip_params = seeded_params(
            blip.init, jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3)),
            jnp.asarray(batch["caption_ids"][:1]), jnp.asarray(batch["caption_mask"][:1]),
            jnp.asarray(batch["caption_labels"][:1]), seed=1)
        cfg = jts.TrainConfig(**c["train"])
        holder = SegmenterHolder(CenterPriorSegmenter(), max_words=4)
        fns[kind] = jts.make_loss_fn(pipe, blip, cfg, extra_losses=(
            jattr.make_attrcon_extra_losses(pipe, holder, cfg) if cfg.attrcon else None))
        trainable, frozen = jts.partition_params(params)
        inputs[kind] = (jax.device_put(trainable, jtp.tp_param_shardings(trainable, mesh)),
                        jax.device_put(frozen, jtp.tp_param_shardings(frozen, mesh)),
                        replicate_tree(blip_params, mesh),
                        shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh))
        extra[kind] = dict(cfg=cfg, params=params, blip_params=blip_params, batch=batch,
                           trainable=trainable)
    rng0 = jax.random.fold_in(jax.random.PRNGKey(5), 0)

    @jax.jit
    def jax_side(inputs):
        return {kind: jax.value_and_grad(fns[kind], has_aux=True)(*inputs[kind], rng0, None)
                for kind in CASES}

    out = jax.device_get(jax_side(inputs))
    cases = {}
    for kind, ((_, (metrics, _)), grads) in out.items():
        e, c = extra[kind], CASES[kind]
        cfg, trainable = e["cfg"], e["trainable"]
        rngs = jax.random.split(rng0, 4)
        trained_idx = np.asarray(jts.sample_trained_idx(rngs[0], cfg))
        rng_noise, lrng = jax.random.split(rngs[1])
        B, h = len(c["prompts"]), c["res"] // 8
        latents0 = np.asarray(jax.random.normal(lrng, (B, h, h, 4)))
        noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng_noise, i),
                                                       (B, h, h, 4)))
                          for i in range(cfg.total_step)])
        crop = tuple(int(jax.random.randint(r, (), 0, c["res"] // 224 + 1))
                     for r in rngs[2:])
        draws = tts.StepDraws(torch.tensor(latents0), torch.tensor(noise),
                              int(trained_idx[0]), crop,
                              tuple(int(i) for i in np.asarray(
                                  jattr.sample_attrcon_draws(rng0, cfg)))
                              if cfg.attrcon else ())
        opt = jts.make_optimizer(cfg)
        updates, _ = opt.update(grads, opt.init(trainable), trainable)
        cases[kind] = dict(
            jcfg=cfg, loss=float(metrics["step_loss"]),
            metrics={k: float(v) for k, v in metrics.items()},
            grads=by_port_name(grads), before=by_port_name(trainable),
            after=by_port_name(optax.apply_updates(trainable, updates)),
            weights=from_jax_params(jax.tree_util.tree_map(
                np.asarray, {**e["params"], "blip": e["blip_params"]})),
            batch=e["batch"], draws=draws)
    return cases


@pytest.mark.parametrize("kind", list(CASES))
def test_tp_step_matches_jax_on_a_dp_tp_mesh(jax_cases, kind):
    case, c = jax_cases[kind], CASES[kind]
    train = {f.name: getattr(case["jcfg"], f.name) for f in dataclasses.fields(tts.TrainConfig)}
    spec = dict(name=c["name"], res=c["res"], lora_rank=RANK, weights=case["weights"],
                batch=case["batch"], draws=case["draws"], train=train, model=2, tp=True,
                attrcon=case["jcfg"].attrcon)
    out = run_ranks(step_rank, 4, spec)
    metrics, grads, after = out[0][:3]
    for other in out[1:]:     # every rank ends with the same whole tensors
        for n in grads:
            np.testing.assert_array_equal(other[1][n], grads[n])
            np.testing.assert_array_equal(other[2][n], after[n])
    assert_step_matches(case, metrics, grads, after, must=("unet.",))
    if kind == "capture":
        for key in ("token_loss", "pixel_loss"):
            assert abs(metrics[key] - case["metrics"][key]) <= 1e-3, key
