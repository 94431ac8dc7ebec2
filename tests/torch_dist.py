"""Run a function in several processes joined by a Gloo process group on
the CPU, for the port's data- and tensor-parallel tests.

`run_ranks(fn, world, *args)` spawns `world` processes (the `spawn`
start method: each imports this module and `fn`'s module afresh), each
with one torch thread, joins them to a Gloo group on a free localhost
port with a 10-minute timeout, calls `fn(rank, world, *args)` and
returns the results by rank. A rank that raises fails the call with its
traceback; the others are then terminated.
"""

import os
import queue
import socket
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 600


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, fn, args, out):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=TIMEOUT_S))
        try:
            out.put((rank, "ok", fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
        raise


def run_ranks(fn, world, *args, timeout=TIMEOUT_S):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, fn, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < world:
            try:
                rank, status, value = out.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))} "
                                   f"sent nothing in {timeout} s")
            if status == "error":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    return [results[r] for r in range(world)]


def tiny_env(rank, world, port, **extra):
    """The environment `torchrun` gives rank `rank` of `world` on this
    machine, for a subprocess of the port's CLI."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               **extra)
    return env


def step_rank(rank, world, spec):
    """One `make_train_step` step of the port on this rank's rows of a
    global batch (tiny geometry, fp32), over a (world / model, model)
    mesh. `spec`: name, res, lora_rank, weights (the pipeline's state
    dicts and "blip", "disc" with the GAN), batch (global, numpy), draws
    (the global batch's StepDraws), train (TrainConfig fields), gan,
    attrcon, model (the model axis), tp (shard the UNet with
    `parallel.tp.apply_tp`). Returns (metrics, G's gradients after the
    all-reduce and before the clip, G's masters after the step, D's
    gradients, this rank's count of scored caption tokens), numpy by
    name; a tensor-parallel shard comes back whole."""
    import numpy as np

    from comat_tpu_torch.config import BLIPConfig
    from comat_tpu_torch.losses import gan as tgan
    from comat_tpu_torch.models import pipeline as tpipe
    from comat_tpu_torch.models.blip import BLIPCaptioner
    from comat_tpu_torch.parallel import mesh as pmesh
    from comat_tpu_torch.parallel import tp as ptp
    from comat_tpu_torch.segmentation import interface as tseg
    from comat_tpu_torch.training import attrcon as tattr
    from comat_tpu_torch.training import train_step as tts

    mesh = pmesh.make_mesh(model=spec.get("model", 1))
    cfg = tpipe.make_pipeline_config(spec["name"], lora_rank=spec["lora_rank"],
                                     resolution=spec["res"], tiny=True)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu", params=spec["weights"])
    plan = {}
    if spec.get("tp"):
        plan = ptp.apply_tp(pipe.unet, mesh)
        ptp.apply_tp(pipe.unet_inf, mesh)
    blip = BLIPCaptioner(BLIPConfig.tiny()).requires_grad_(False)
    blip.load_state_dict(spec["weights"]["blip"])
    tcfg = tts.TrainConfig(**spec["train"])
    batch = {k: pmesh.local_rows(v, mesh) for k, v in spec["batch"].items()}
    disc = d_opt = extra = None
    if spec.get("gan"):
        disc = tgan.Discriminator(cfg.unet, tgan.GanConfig(lora_rank=spec["lora_rank"]),
                                  device="cpu", base_unet=pipe.unet)
        own = {n: v for n, v in spec["weights"]["disc"].items()
               if "lora_" in n or n.startswith("head.")}
        disc.load_state_dict(own, strict=False)
    if spec.get("attrcon"):
        holder = tseg.SegmenterHolder(tseg.CenterPriorSegmenter(), max_words=4)
        extra = tattr.make_attrcon_extra_losses(pipe, holder, tcfg)
    state = tts.init_train_state(pipe, tcfg)
    if disc is not None:
        d_opt = tts.init_disc_state(disc, tcfg).optimizer
    seen = {"g": {}, "d": {}}

    def recorder(opt, key):
        step = opt.step

        def recording(reduce=None, norm=None):
            def rec(grads):
                if reduce is not None:
                    reduce(grads)
                seen[key].update({n: m.grad.detach().clone() for n, m in opt.masters.items()})
            return step(rec, norm)

        opt.step = recording

    recorder(state.optimizer, "g")
    if d_opt is not None:
        recorder(d_opt, "d")
    step = tts.make_train_step(pipe, blip, tcfg, extra, disc, d_opt, mesh=mesh)
    state, metrics = step(state, batch, spec["draws"])
    shard = {f"unet.{n}": s for n, s in plan.items()}

    def whole(name, t):
        return ptp.gather_shard(t, shard.get(name), mesh).numpy()

    grads = {n: whole(n, g) for n, g in seen["g"].items()}
    after = {n: whole(n, m.detach()) for n, m in state.optimizer.masters.items()}
    labels = np.asarray(batch["caption_labels"])
    count = int((labels[:, 1:] != -100).sum())
    return (metrics, grads, after, {n: g.numpy() for n, g in seen["d"].items()}, count)


def tp_unet_rank(rank, world, spec):
    """A tiny UNet (`spec["config"]`: "sd15" or "sdxl") seeded with nonzero
    LoRA B, sharded by `apply_tp` over a (1, world) mesh beside its
    unsharded copy: one capture forward of a CFG-sized batch on the same
    inputs, then the backward of a fixed weighting of eps and the captured
    maps. Returns {"eps", "maps", "grads", "plan"}: the largest relative
    differences (max |delta| over max |value|), the LoRA gradients whole."""
    import copy

    from comat_tpu_torch.config import UNetConfig
    from comat_tpu_torch.models.unet import UNet2DConditionModel
    from comat_tpu_torch.parallel import mesh as pmesh
    from comat_tpu_torch.parallel import tp as ptp
    from comat_tpu_torch.weights import init_weights_

    mesh = pmesh.make_mesh(data=1, model=world)
    xl = spec["config"] == "sdxl"
    cfg = UNetConfig.tiny_xl() if xl else UNetConfig.tiny()
    g = torch.Generator().manual_seed(0)
    unet = UNet2DConditionModel(cfg, lora_rank=4)
    init_weights_(unet, g)
    with torch.no_grad():
        for n, p in unet.named_parameters():
            if n.endswith("lora_b"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    ref = copy.deepcopy(unet)
    plan = ptp.apply_tp(unet, mesh)
    B, h = 2, 16
    x = torch.randn((B, h, h, 4), generator=g)
    ctx = torch.randn((B, 77, 32), generator=g)
    added = None
    if xl:
        added = {"text_embeds": torch.randn((B, 32), generator=g),
                 "time_ids": torch.randn((B, 6), generator=g)}
    w = torch.randn((B, h, h, 4), generator=g)
    wm = {}

    def run(model):
        eps, maps = model(x, 500, ctx, added, capture=True)
        flat = [m for v in maps.values() for m in v]
        # a weighting of every probability (a constant a row would have no
        # gradient: the rows sum to one)
        for i, m in enumerate(flat):
            wm.setdefault(i, torch.randn(m.shape, generator=g))
        loss = (eps.float() * w).sum() + sum((m * wm[i]).sum() for i, m in enumerate(flat))
        lora = {n: p for n, p in model.named_parameters() if "lora_" in n}
        grads = torch.autograd.grad(loss, list(lora.values()))
        return eps.detach(), [m.detach() for m in flat], dict(zip(lora, grads))

    e0, m0, g0 = run(ref)
    e1, m1, g1 = run(unet)

    def rel(a, b):
        return float((a - b).abs().max() / max(a.abs().max(), b.abs().max(), 1e-30))

    grads = {n: rel(ptp.gather_shard(g1[n], plan.get(n), mesh), g0[n]) for n in g0}
    return {"eps": rel(e1, e0), "maps": max(rel(a, b) for a, b in zip(m1, m0)),
            "n_maps": len(m0), "grads": grads, "plan": sorted(plan)}
