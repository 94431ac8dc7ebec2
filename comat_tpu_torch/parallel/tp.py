"""Tensor parallelism of the UNet over a mesh's model group (Megatron).

The port's counterpart of comat_tpu/parallel/tp.py. JAX states the rule
as parameter shardings and lets GSPMD insert the collectives; PyTorch
runs each rank's shard as a module of its own, so the rule comes with
the layers that run it:

- the attention's q, k and v projections are column-parallel (each rank
  keeps a block of the output features, so a block of whole heads) and
  its output projection row-parallel (the matching block of input
  features), the feed-forward's GEGLU projection column-parallel (each
  rank keeps its slice of the values and the same slice of the gates:
  JAX's last-axis split of the (dim, 2, 4 dim) kernel) and its output
  projection row-parallel: one all-reduce in each attention's and each
  feed-forward's forward, one (two with LoRA) in each backward;
- everything else is replicated.

`tp_plan` is JAX's `_spec_for` on the port's names plus one condition:
the attention's heads must divide by the model axis, since
`multi_head_attention` runs on local heads where GSPMD can reshard
across the head reshape. Elsewhere the attention stays replicated, the
same math, as sharding never changes it in JAX. SD1.5 (8 heads) and SDXL
(10 and 20) shard at M = 2; SDXL at M = 4 keeps its 10-head level
replicated.

`apply_tp(unet, mesh)` shards a UNet in place, its LoRA included: a
column-parallel layer shards its base rows and LoRA B's output columns
(A replicated), a row-parallel one its base columns and LoRA A's input
rows (B replicated). The collectives are autograd Functions, so the
cached-primal replay and the capture, which differentiate by running the
UNet again, go through them. The capture all-gathers the local heads'
probabilities in head order, so the grounding losses see every head.
Apply it to a pipeline's UNet and to its LoRA-free twin (`unet_inf`), so
that `fuse_lora` folds each shard into its own, before the train state is
made; a step with `make_train_step(mesh=)` then clips by the norm that
counts each shard once across its model group. JAX's trainer never
applies its rule (`Trainer` replicates), and neither does the port's.
W8A8 (--pass1_int8) under it raises: a row-parallel input's per-token
absmax would span ranks.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from comat_tpu_torch.models.lora import LoRALinear
from comat_tpu_torch.models.quant import QLinear
from comat_tpu_torch.models.unet import Attention, FeedForward
from comat_tpu_torch.parallel.mesh import Mesh


class Shard(NamedTuple):
    """A tensor's dim `dim` seen as `parts` equal blocks, each split over
    the model group: rank i keeps slice i of every block ([values, gates]
    of the GEGLU projection: parts 2)."""

    dim: int
    parts: int = 1


_ATTN = re.compile(r"(.*\.attn[12])\.(to_q|to_k|to_v|to_out\.0)\.(base\.weight|lora_a|lora_b)")
_FF_IN = re.compile(r".*\.ff\.net\.0\.proj\.(weight|bias)")
_FF_OUT = re.compile(r".*\.ff\.net\.2\.weight")


def tp_plan(named_shapes: Mapping[str, Sequence[int]], model_size: int,
            heads_of: Callable[[str], int]) -> Dict[str, Shard]:
    """{name: Shard} of the tensors to shard over `model_size` ranks
    (torch layouts: a linear weight (out, in), the port's lora_a (in, r)
    and lora_b (r, out)); the others are replicated. `heads_of(prefix)`
    gives the heads of the attention module `prefix` ("...attn1")."""
    plan: Dict[str, Shard] = {}
    if model_size == 1:
        return plan
    for name, shape in named_shapes.items():
        m = _ATTN.fullmatch(name)
        if m is not None:
            if heads_of(m.group(1)) % model_size:
                continue        # whole heads only: the attention stays replicated
            column = m.group(2) != "to_out.0"
            kind = m.group(3)
            if kind == "base.weight":
                features = shape[0] if column else shape[1]
                if features % model_size == 0:
                    plan[name] = Shard(0 if column else 1)
            elif kind == "lora_b" and column and shape[1] % model_size == 0:
                plan[name] = Shard(1)
            elif kind == "lora_a" and not column and shape[0] % model_size == 0:
                plan[name] = Shard(0)
            continue
        if _FF_IN.fullmatch(name) and (shape[0] // 2) % model_size == 0:
            plan[name] = Shard(0, parts=2)
        elif _FF_OUT.fullmatch(name) and shape[1] % model_size == 0:
            plan[name] = Shard(1)
    return plan


def shard_of(t: torch.Tensor, shard: Shard, index: int, size: int) -> torch.Tensor:
    """Rank `index`'s slice of `t` under `shard` (a copy)."""
    blocks = t.chunk(shard.parts, dim=shard.dim)
    return torch.cat([b.chunk(size, dim=shard.dim)[index] for b in blocks],
                     dim=shard.dim).clone()


# ---- the collectives, differentiable ----

class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group (the input of a column-parallel layer), in fp32."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = g.float().contiguous().clone()
        dist.all_reduce(total, group=ctx.group)
        return total.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group forward (a row-parallel layer's
    partial products); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherHeads(torch.autograd.Function):
    """(B, H/M, ...) -> (B, H, ...), the ranks' heads in rank order (a sum
    of zero-padded blocks, which every backend reduces); the backward
    keeps this rank's heads of the gradient, which every rank of the
    group computes alike."""

    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.index, ctx.h = index, x.shape[1]
        full = x.new_zeros((x.shape[0], x.shape[1] * size, *x.shape[2:]))
        full[:, index * x.shape[1]:(index + 1) * x.shape[1]] = x
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.h
        return g[:, lo:lo + ctx.h].contiguous(), None, None, None


# ---- the layers ----

class ColumnParallelLoRALinear(LoRALinear):
    """y_i = x W_i^T + copy(x A) B_i: rank i's block of the outputs; the
    input's gradient and that of x A are summed over the group."""

    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(_CopyToModel.apply(x, self.tp_group), self.base.weight, self.base.bias)
        if self.lora_rank > 0:
            dt = self.base.weight.dtype
            t = _CopyToModel.apply(x.to(dt) @ self.lora_a.to(dt), self.tp_group)
            y = y + (t @ self.lora_b.to(dt)).to(y.dtype)
        return y


class RowParallelLoRALinear(LoRALinear):
    """y = sum_i (x_i W_i^T, x_i A_i), then + bias and (sum x_i A_i) B:
    rank i holds the block x_i of the input features; the partial
    products are summed in fp32 in one all-reduce."""

    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.base.weight
        parts = [F.linear(x, w)]
        if self.lora_rank > 0:
            parts.append(x.to(w.dtype) @ self.lora_a.to(w.dtype))
        summed = _ReduceFromModel.apply(torch.cat(parts, -1).float(), self.tp_group)
        y = summed[..., :w.shape[0]].to(w.dtype)
        if self.base.bias is not None:
            y = y + self.base.bias
        if self.lora_rank > 0:
            t = summed[..., w.shape[0]:].to(w.dtype)
            y = y + t @ self.lora_b.to(w.dtype)
        return y


class ColumnParallelLinear(QLinear):
    """The GEGLU projection's [values_i, gates_i] block of rows."""

    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(_CopyToModel.apply(x, self.tp_group), self.weight, self.bias)


class RowParallelLinear(QLinear):
    """The feed-forward's output projection over its block of inputs."""

    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _ReduceFromModel.apply(F.linear(x, self.weight).float(), self.tp_group)
        y = y.to(self.weight.dtype)
        return y + self.bias if self.bias is not None else y


class ParallelAttention(Attention):
    """Attention over the local heads; a capture gathers every head's
    probabilities."""

    tp_group = None
    tp_index = 0
    tp_size = 1

    def forward(self, x: torch.Tensor, context=None,
                sink=None) -> torch.Tensor:
        if sink is None:
            return super().forward(x, context)
        local: list = []
        out = super().forward(x, context, local)
        sink.append(_GatherHeads.apply(local[0], self.tp_group, self.tp_index,
                                       self.tp_size))
        return out


def _heads_by_module(unet: nn.Module) -> Dict[str, int]:
    return {n: m.heads for n, m in unet.named_modules() if isinstance(m, Attention)}


def unet_plan(unet: nn.Module, model_size: int) -> Dict[str, Shard]:
    """`tp_plan` of a UNet module's parameters."""
    heads = _heads_by_module(unet)
    return tp_plan({n: tuple(p.shape) for n, p in unet.named_parameters()}, model_size,
                   heads.__getitem__)


@torch.no_grad()
def apply_tp(unet: nn.Module, mesh: Mesh) -> Dict[str, Shard]:
    """Shard `unet` in place over `mesh`'s model group (`unet_plan`): each
    planned tensor becomes this rank's slice, a new Parameter with the old
    one's `requires_grad`; the layers that hold them run the parallel
    forwards; a sharded attention runs its local heads. Records the plan's
    names as `unet.tp_sharded`. Returns the plan."""
    if mesh.model == 1:
        return {}
    if mesh.model_group is None:
        raise ValueError("tensor parallelism needs a process group")
    plan = unet_plan(unet, mesh.model)
    modules = dict(unet.named_modules())
    for name, shard in plan.items():
        owner, leaf = name.rsplit(".", 1)
        module = modules[owner]
        p = getattr(module, leaf)
        local = shard_of(p.detach(), shard, mesh.model_index, mesh.model)
        setattr(module, leaf, nn.Parameter(local, requires_grad=p.requires_grad))
    sharded_layers = {n.rsplit(".", 1)[0] for n in plan}
    for name, module in modules.items():
        if isinstance(module, Attention) and f"{name}.to_q.base" in sharded_layers:
            module.__class__ = ParallelAttention
            module.heads //= mesh.model
            module.tp_index, module.tp_size = mesh.model_index, mesh.model
            for proj in (module.to_q, module.to_k, module.to_v):
                proj.__class__ = ColumnParallelLoRALinear
            module.to_out[0].__class__ = RowParallelLoRALinear
            layers = (module, module.to_q, module.to_k, module.to_v, module.to_out[0])
        elif isinstance(module, FeedForward) and f"{name}.net.0.proj" in sharded_layers:
            module.net[0].proj.__class__ = ColumnParallelLinear
            module.net[2].__class__ = RowParallelLinear
            layers = (module.net[0].proj, module.net[2])
        else:
            continue
        for layer in layers:
            layer.tp_group = mesh.model_group
    unet.tp_sharded = frozenset(plan)
    return plan


def gather_shard(t: torch.Tensor, shard: Optional[Shard], mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's `shard` of it (a copy; `t`
    itself when replicated)."""
    if shard is None or mesh.model == 1:
        return t
    pieces = []
    for i in range(mesh.model):
        piece = t.detach().clone() if i == mesh.model_index else torch.zeros_like(t)
        dist.broadcast(piece, src=mesh.model_root + i, group=mesh.model_group)
        pieces.append(piece.chunk(shard.parts, dim=shard.dim))
    return torch.cat([torch.cat([p[b] for p in pieces], dim=shard.dim)
                      for b in range(shard.parts)], dim=shard.dim)
