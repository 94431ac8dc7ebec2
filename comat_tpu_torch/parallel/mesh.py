"""Process groups for data parallelism and the model axis.

The port's counterpart of comat_tpu/parallel/mesh.py and of
training_script.py's `maybe_init_distributed`. The reference trains with
accelerate's DDP over 8 GPUs (node8.yaml); JAX lays all chips out as one
('data', 'model') mesh and lets GSPMD insert the collectives. The port
runs one process per card under `torchrun` and lays the ranks out as JAX
lays out its devices, `arange(world).reshape(data, model)` row-major:
rank r sits at data index r // model and model index r % model.

Two kinds of process group come with a `Mesh`:

- `data_group`: the ranks of one model index, one per data index. They
  hold different rows of the global batch; a step sums its loss shares,
  token counts and gradients over this group (`all_reduce_grads`).
- `model_group`: the ranks of one data index. They hold the same rows:
  replicas of one another under the trainer's `--mesh_model_axis`, as in
  JAX's trainer, or the shards of one UNet under `parallel.tp`.

`local_rows` takes this data index's rows of a global-batch tensor,
`replicate` broadcasts the first data index's tensors to the others. A
mesh without a process group (world 1, groups None) runs no collective.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the rendezvous and every collective wait this long before failing: a
# rank that compiles kernels or loads weights may start minutes later
TIMEOUT = datetime.timedelta(minutes=10)
# elements per flat fp32 bucket of `all_reduce_grads` (128 MB)
BUCKET_ELEMS = 1 << 25


def init_distributed(environ: Optional[Mapping[str, str]] = None,
                     device: str = "cuda") -> bool:
    """Join the process group `torchrun` describes in the environment
    (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). The gate is
    the environment alone: nothing here touches CUDA before it decides.
    NCCL for a CUDA `device`, bound to cuda:LOCAL_RANK, which becomes the
    current device; Gloo for the CPU. A process that already holds a
    default group keeps it. Returns whether it initialised a group."""
    env = os.environ if environ is None else environ
    if "WORLD_SIZE" not in env or "RANK" not in env:
        return False
    if dist.is_initialized():
        return False
    world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    url = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if torch.device(device).type == "cpu":
        dist.init_process_group("gloo", init_method=url, world_size=world, rank=rank,
                                timeout=TIMEOUT)
        return True
    local = torch.device("cuda", int(env.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", init_method=url, world_size=world, rank=rank,
                            timeout=TIMEOUT, device_id=local)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`world` ranks as (data, model), row-major; this process is `rank`.
    The groups are None without a process group."""

    world: int
    rank: int
    data: int
    model: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def data_root(self) -> int:
        """The global rank at data index 0 of this rank's model index."""
        return self.model_index

    @property
    def model_root(self) -> int:
        """The global rank at model index 0 of this rank's data index."""
        return self.data_index * self.model


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The mesh of the default process group (world 1 without one). Every
    rank must call it, in the same order as its other group calls: each
    subgroup is made on every rank. Raises where data x model is not the
    world, as JAX's `make_mesh` asserts."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data is None:
        data = world // model
    if data * model != world or data < 1:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks, "
                         f"the world has {world}")
    if not dist.is_initialized():
        return Mesh(world, rank, data, model)
    data_group = model_group = None
    for j in range(model):
        g = dist.new_group([i * model + j for i in range(data)], timeout=TIMEOUT)
        if rank % model == j:
            data_group = g
    for i in range(data):
        g = dist.new_group([i * model + j for j in range(model)], timeout=TIMEOUT)
        if rank // model == i:
            model_group = g
    return Mesh(world, rank, data, model, data_group, model_group)


def local_rows(x, mesh: Mesh, dim: int = 0):
    """This data index's rows of a global-batch tensor or array along
    `dim`, in global order: the block data_index of `data` equal blocks.
    The ranks of one model group get the same rows (JAX's `_local_rows`
    takes each row once across the model axis's replicas)."""
    n = x.shape[dim]
    if n % mesh.data:
        raise ValueError(f"{n} rows do not split over {mesh.data} data groups")
    b = n // mesh.data
    lo = mesh.data_index * b
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, lo, b)
    return np.take(np.asarray(x), np.arange(lo, lo + b), axis=dim)


def sum_over_data(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`t` summed in place over the data group (its ranks' rows)."""
    if mesh.data_group is not None:
        dist.all_reduce(t, group=mesh.data_group)
    return t


def _buckets(tensors: Sequence[torch.Tensor], limit: int):
    """Consecutive runs of `tensors` of one dtype and device, each run
    at most `limit` elements (or one larger tensor)."""
    run: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        if run and (size + t.numel() > limit or t.dtype != run[0].dtype
                    or t.device != run[0].device):
            yield run
            run, size = [], 0
        run.append(t)
        size += t.numel()
    if run:
        yield run


@torch.no_grad()
def all_reduce_grads(grads: Iterable[torch.Tensor], mesh: Mesh) -> int:
    """Sum fp32 gradient tensors in place over the data group, in flat
    buckets: one collective a bucket, not a tensor. Returns the bytes
    reduced (0 without a process group)."""
    grads = list(grads)
    for g in grads:
        if g.dtype != torch.float32:
            raise TypeError(f"all_reduce_grads sums fp32 gradients, got {g.dtype}")
    if mesh.data_group is None:
        return 0
    nbytes = 0
    for run in _buckets(grads, BUCKET_ELEMS):
        flat = torch.cat([g.reshape(-1) for g in run])
        dist.all_reduce(flat, group=mesh.data_group)
        for g, part in zip(run, flat.split([g.numel() for g in run])):
            g.copy_(part.view_as(g))
        nbytes += flat.numel() * flat.element_size()
    return nbytes


def grad_norm(grads: Mapping[str, torch.Tensor], mesh: Optional[Mesh] = None,
              sharded: Iterable[str] = ()) -> torch.Tensor:
    """The global norm of gradients that are each the whole batch's: the
    squares of a replicated tensor counted once, those of a tensor
    `sharded` over the model group (parallel.tp) summed over its shards."""
    sharded = set(sharded)
    rep = [g.square().sum() for n, g in grads.items() if n not in sharded]
    sq = torch.stack(rep).sum() if rep else None
    parts = [g.square().sum() for n, g in grads.items() if n in sharded]
    if parts:
        part = torch.stack(parts).sum()
        if mesh is not None and mesh.model_group is not None:
            dist.all_reduce(part, group=mesh.model_group)
        sq = part if sq is None else sq + part
    return sq.sqrt()


@torch.no_grad()
def replicate(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Overwrite `tensors` in place with those of data index 0 of this
    rank's model index (JAX's `replicate_tree`): every data group starts
    from the same trainable and optimizer state, and the shards of a
    tensor-parallel layer stay with their model index."""
    if mesh.data_group is None:
        return
    for run in _buckets(list(tensors), BUCKET_ELEMS):
        flat = torch.cat([t.reshape(-1) for t in run])
        dist.broadcast(flat, src=mesh.data_root, group=mesh.data_group)
        for t, part in zip(run, flat.split([t.numel() for t in run])):
            t.copy_(part.view_as(t))


def any_rank(flag: bool, mesh: Mesh, device: torch.device) -> bool:
    """True on every rank when `flag` is on any rank of the world."""
    if mesh.data_group is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def all_gather_objects(obj, mesh: Mesh) -> List[object]:
    """Every rank's `obj` by rank (picklable host objects)."""
    if mesh.data_group is None:
        return [obj]
    out: List[object] = [None] * mesh.world
    dist.all_gather_object(out, obj)
    return out


def barrier(mesh: Mesh) -> None:
    if mesh.data_group is not None:
        dist.barrier()


def broadcast_model(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`t` in place from model index 0 to the rest of its model group."""
    if mesh.model_group is not None and mesh.model > 1:
        dist.broadcast(t, src=mesh.model_root, group=mesh.model_group)
    return t


def gather_metrics(values: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """0-dim tensors summed over the data group in one collective."""
    if mesh.data_group is None or not values:
        return values
    names = list(values)
    flat = torch.stack([values[n].detach().float().reshape(()) for n in names])
    dist.all_reduce(flat, group=mesh.data_group)
    return dict(zip(names, flat.unbind()))
