"""W8A8 pass 1 (--pass1_int8) on a UNet sharded by `parallel.tp.apply_tp`,
against the same UNet unsharded, over two Gloo processes on the CPU.

The unsharded int8 UNet is held to JAX by tests/test_torch_quant.py; here
the sharded one is held to it bit for bit:

- the int8 weight set: each rank's codes are the unsharded codes' slice
  (a column-parallel layer's rows, a row-parallel layer's columns), its
  scales the unsharded scales (a row-parallel layer's over the whole row);
- one guided call of the LoRA-free UNet (the fused pass 1's): every
  activation scale equal, every activation's codes the unsharded codes
  or, into a row-parallel layer, their slice, and eps equal;
- a row-parallel layer with a LoRA branch (the unfused pass 1): equal with
  its LoRA up factor zero; within 1e-6 of the largest output with it
  nonzero, the LoRA branch's partial products being summed in fp32 across
  the ranks.
"""

import copy

import numpy as np
import pytest
import torch

from torch_dist import run_ranks

WORLD = 2


def int8_rank(rank, world, spec):
    from comat_tpu_torch.config import UNetConfig
    from comat_tpu_torch.models import quant as mq
    from comat_tpu_torch.models.unet import UNet2DConditionModel
    from comat_tpu_torch.ops import quant as oq
    from comat_tpu_torch.parallel import mesh as pmesh
    from comat_tpu_torch.parallel import tp as ptp
    from comat_tpu_torch.weights import init_weights_

    mesh = pmesh.make_mesh(data=1, model=world)
    xl = spec["config"] == "sdxl"
    cfg = UNetConfig.tiny_xl() if xl else UNetConfig.tiny()
    g = torch.Generator().manual_seed(0)
    unet = UNet2DConditionModel(cfg, lora_rank=spec["lora_rank"])
    init_weights_(unet, g)
    with torch.no_grad():
        for n, p in unet.named_parameters():
            if n.endswith("lora_b"):
                p.copy_(spec["lora_b"] * torch.randn(p.shape, generator=g))
    ref = copy.deepcopy(unet)
    plan = ptp.apply_tp(unet, mesh)
    B, h = 2, 16
    x = torch.randn((B, h, h, 4), generator=g)
    ctx = torch.randn((B, 77, 32), generator=g)
    added = None
    if xl:
        added = {"text_embeds": torch.randn((B, 32), generator=g),
                 "time_ids": torch.randn((B, 6), generator=g)}

    calls = []
    inner = oq.quantize

    def recording(x, groups, role="act", group=None):
        q, s = inner(x, groups, role, group)
        calls[-1].append((q.reshape(groups, -1).numpy(), s.numpy()))
        return q, s

    oq.quantize = recording
    try:
        with torch.no_grad():
            out = {}
            for key, model in (("ref", ref), ("tp", unet)):
                weights = mq.quantize_unet(model)
                calls.append([])
                with mq.installed(model, weights):
                    eps = model(x, 500, ctx, added)
                out[key] = (weights, eps, calls[-1])
    finally:
        oq.quantize = inner

    (w0, e0, a0), (w1, e1, a1) = out["ref"], out["tp"]
    weights = {}
    for name, w in w0.items():
        shard = plan.get(name + ".weight")
        q = ptp.shard_of(w.q, shard, rank, world) if shard is not None else w.q
        scale_shard = shard if shard is not None and shard.dim == 0 else None
        s = ptp.shard_of(w.scale, scale_shard, rank, world) if scale_shard else w.scale
        weights[name] = (torch.equal(q, w1[name].q), torch.equal(s, w1[name].scale))
    acts = []
    for (q0, s0), (q1, s1) in zip(a0, a1):
        if q1.shape[1] != q0.shape[1]:      # a row-parallel input: this rank's block
            k = q1.shape[1]
            q0 = q0[:, rank * k:(rank + 1) * k]
        acts.append((np.array_equal(q0, q1), np.array_equal(s0, s1)))

    # the row-parallel attention output with its LoRA branch, alone
    layer = {}
    name = next(n for n in w0 if n.endswith("attn1.to_out.0.base"))
    owner = name[:-len(".base")]
    lref, ltp = ref.get_submodule(owner), unet.get_submodule(owner)
    inp = torch.randn((B * 64, lref.base.in_features), generator=g)
    k = ltp.base.weight.shape[1]
    with torch.no_grad(), mq.installed(ref, w0), mq.installed(unet, w1):
        layer["out"] = float((ltp(inp[:, rank * k:(rank + 1) * k]) - lref(inp)).abs().max()
                             / lref(inp).abs().max())
    return {"weights": weights, "acts": acts, "n_acts": (len(a0), len(a1)),
            "eps": torch.equal(e0, e1), "layer": layer,
            "row": sum(1 for n in w1 if getattr(unet.get_submodule(n), "row_group", None)),
            "plan": len(plan)}


@pytest.mark.parametrize("config", ["sd15", "sdxl"])
def test_sharded_int8_unet_equals_the_unsharded_bit_for_bit(config):
    out = run_ranks(int8_rank, WORLD, {"config": config, "lora_rank": 0, "lora_b": 0.0})
    for r in out:
        assert r["plan"] > 0 and r["row"] > 0
        assert r["weights"] and all(all(v) for v in r["weights"].values()), \
            [n for n, v in r["weights"].items() if not all(v)]
        assert r["n_acts"][0] == r["n_acts"][1] > 0
        assert all(q and s for q, s in r["acts"]), r["acts"]
        assert r["eps"]
        assert r["layer"]["out"] == 0.0


@pytest.mark.parametrize("lora_b,tol", [(0.0, 0.0), (0.1, 1e-6)])
def test_row_parallel_int8_layer_with_lora(lora_b, tol):
    out = run_ranks(int8_rank, WORLD, {"config": "sd15", "lora_rank": 4, "lora_b": lora_b})
    for r in out:
        assert all(all(v) for v in r["weights"].values())
        assert r["layer"]["out"] <= tol, r["layer"]
