"""Pass 1's guided eps call replayed as one CUDA graph.

Pass 1 calls the guided UNet S times (50 in the trainer) without
gradients, at shapes fixed for a run, and each call launches ~2,000
kernels: on its own the host cannot queue them as fast as the card runs
them. `Pass1Graph` captures one call (the CFG UNet at batch 2B, the v->eps
conversion, the guidance combine) in a CUDA graph on its first call and
replays it on every later one: the host then queues one graph launch and
two small copies a call.

A `DiffusionPipeline` holds one `Pass1Graph`, so at most one graph; its
`eps_model` wraps each pass's `GuidedEps` (`diffusion/guidance.py`) in a
`GraphedEps`. A call replays when everything the graph fixed is as it was
at the capture (`GraphedEps._key`): the UNet object itself (held, compared
with `is`) and the address of each of its tensors (`fused_unet()` loads
the twin in place, so they stay), the shapes and dtypes of the latents
and of the conditions, the guidance and its scale and rescale, the added
condition's keys and `prediction_type`. A new key drops the old graph and
its memory pool and captures again. The call that captures runs eagerly
first, on a side stream (PyTorch's recipe: lazy set-up such as cuBLAS's
workspace for that stream happens outside the capture), and returns that
eager result; the capture itself runs nothing.

The graph is taken only where the input allows it; every other call runs
the wrapped eps model eagerly, unchanged: CPU tensors, a grad-enabled
context, a timestep that is not a tensor on the latents' device (an
upload inside a capture would block), a UNet with an int8 weight set
installed (`models/quant.py`: `pass1_w8a8` installs fresh weights each
pass, so the graph's would go stale) or holding tensor-parallel layers
(`parallel/tp.py`: their collectives). The UNet's state is read at the
first call of each eps model; the rest at every call.

Inputs enter through static buffers, by device-to-device copies: the
latents and the timestep at every call, the context and the added
condition when an eps model other than the last one calls. The eps
returned by a replay is the graph's static output, overwritten by the
next call: a caller copies what it keeps (`sample_inference` writes it
into its table).

Counters: each call tallies "pass1_graph" (a replay) or "pass1_eager" on
the active clock (`comat_tpu_torch.trace`), and each capture
"pass1_capture" and the process's `CAPTURES`. A replay adds the hand-
written kernels' launches that the capture recorded to their counters
(`ops/_build.py`), and the capture takes its own back out, so the counts
say how often each kernel ran.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import torch

from comat_tpu_torch import trace
from comat_tpu_torch.diffusion.guidance import GuidedEps
from comat_tpu_torch.ops import _build

CAPTURES = 0        # graph captures in this process


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def _blocked(unet: torch.nn.Module) -> bool:
    """Whether `unet` holds an installed int8 weight set or tensor-parallel
    layers, which a graph cannot replay."""
    return any(getattr(m, "w8a8", None) is not None or getattr(m, "tp_group", None) is not None
               for m in unet.modules())


def _layout(t: Optional[torch.Tensor]):
    return None if t is None else (tuple(t.shape), t.dtype)


def _launch_counts():
    return [(k, k.launches, collections.Counter(k.launches_by_shape)) for k in _build.KERNELS]


class GraphedEps:
    """A pass's guided eps model (`GuidedEps`, kept as `eager`) that
    replays its pipeline's graph where it can (see the module's
    docstring)."""

    def __init__(self, owner: "Pass1Graph", eager: GuidedEps, unet: torch.nn.Module,
                 prediction_type: str):
        self.owner, self.eager, self.unet = owner, eager, unet
        self.prediction_type = prediction_type
        self._fixed: Optional[Tuple] = None     # the key's part read once, or () if blocked

    def _key(self, x: torch.Tensor, t: torch.Tensor) -> Optional[Tuple]:
        """What the graph fixes for this call, or None where no graph may run."""
        if (not _on_card(x) or torch.is_grad_enabled()
                or not isinstance(t, torch.Tensor) or t.device != x.device):
            return None
        if self._fixed is None:
            unet = self.unet
            self._fixed = () if _blocked(unet) else (
                tuple(p.data_ptr() for p in unet.parameters()),
                tuple(b.data_ptr() for b in unet.buffers()))
        if not self._fixed:
            return None
        e = self.eager
        added = None if e.added is None else tuple(
            (k, _layout(v)) for k, v in sorted(e.added.items()))
        return (self._fixed, _layout(x), _layout(t), _layout(e.context), added, e.guided,
                e.guidance_scale, e.guidance_rescale, self.prediction_type)

    def __call__(self, x: torch.Tensor, t) -> torch.Tensor:
        key = self._key(x, t)
        if key is None:
            trace.tally("pass1_eager")
            return self.eager(x, t)
        return self.owner.run(self, key, x, t)


class Pass1Graph:
    """A pipeline's pass-1 graph: at most one, with its static buffers."""

    def __init__(self):
        self.release()
        self._stream: Optional[torch.cuda.Stream] = None

    def release(self) -> None:
        """Drop the graph, its memory pool and its buffers."""
        self._key = self._unet = self._graph = None
        self._static: Dict[str, object] = {}
        self._out: Optional[torch.Tensor] = None
        self._loaded: Optional[GraphedEps] = None   # whose conditions the buffers hold
        self._recorded: List[Tuple[_build.CudaKernel, int, collections.Counter]] = []

    def eps_model(self, eager: GuidedEps, unet: torch.nn.Module,
                  prediction_type: str) -> GraphedEps:
        return GraphedEps(self, eager, unet, prediction_type)

    def holds(self, unet: torch.nn.Module) -> bool:
        """Whether the graph was captured on `unet`."""
        return self._unet is unet

    def run(self, model: GraphedEps, key: Tuple, x: torch.Tensor,
            t: torch.Tensor) -> torch.Tensor:
        if self._unet is not model.unet or self._key != key:
            return self._capture(model, key, x, t)
        st = self._static
        if self._loaded is not model:
            st["context"].copy_(model.eager.context)
            for k, v in st["added"].items():
                v.copy_(model.eager.added[k])
            self._loaded = model
        st["x"].copy_(x)
        st["t"].copy_(t)
        self._graph.replay()
        for kernel, n, shapes in self._recorded:
            kernel.launches += n
            kernel.launches_by_shape.update(shapes)
        trace.tally("pass1_graph")
        return self._out

    def _capture(self, model: GraphedEps, key: Tuple, x: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
        global CAPTURES
        self.release()
        e = model.eager
        st = {"x": x.clone(), "t": t.clone(), "context": e.context.clone(),
              "added": {k: v.clone() for k, v in (e.added or {}).items()}}
        added = st["added"] if e.added is not None else None
        if self._stream is None or self._stream.device != x.device:
            self._stream = torch.cuda.Stream(device=x.device)
        side, main = self._stream, torch.cuda.current_stream(x.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            eps = e.apply(st["x"], st["t"], st["context"], added)
        main.wait_stream(side)
        eps.record_stream(main)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        with trace.sync("pass1.capture"):
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                out = e.apply(st["x"], st["t"], st["context"], added)
        recorded = []
        for kernel, n, shapes in before:
            if kernel.launches != n:
                taken = kernel.launches_by_shape - shapes
                recorded.append((kernel, kernel.launches - n, taken))
                kernel.launches = n             # recorded, not run
                kernel.launches_by_shape -= taken
        self._key, self._unet, self._graph = key, model.unet, graph
        self._static, self._out, self._loaded, self._recorded = st, out, model, recorded
        CAPTURES += 1
        trace.tally("pass1_capture")
        trace.tally("pass1_eager")
        return eps
