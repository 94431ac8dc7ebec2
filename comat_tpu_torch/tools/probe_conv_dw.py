"""Where the bf16 dw of the 3x3 conv spends its time, and how far it lands
from an fp64 sum of the same bf16 inputs, beside cuDNN's bf16
`conv2d_weight`.

    python -m comat_tpu_torch.tools.probe_conv_dw

For each dw shape of the 512^2 decoder at batch 4 (chip_smoke.py's
inputs, seed 1) this prints two lines.

Time: the pixel split the wrapper picks (`dw_splits`: splits, blocks,
waves of 132, fp32 workspace); the wrapper's and cuDNN's times (CUDA
events, in turns: kernel, cuDNN, cuDNN, kernel; the mean and each run);
the device time of each kernel in the wrapper from `torch.profiler`: the
wgmma pass (`conv3x3_dw_bf16_kernel`) and the fixed-order reduction of
the splits (`conv3x3_dw_reduce`); then cuDNN's kernels and the forward
kernel B (`conv3x3_fwd`) at the same shape, the same count of
products.

Rounding: dw sums B*H*W products of bf16 x and dy in fp32 and rounds the
sum to bf16 once. The kernel sums on the tensor cores in its own order,
the plain version (`conv3x3_dw_ref`) on cuBLAS's fp32 GEMM (TF32 off);
the fp64 sum r of the same products, rounded to bf16, is the correctly
rounded result. For the kernel, the plain version and cuDNN: the largest
|x - r| / (1e-2 + 2^-7 |r|) (chip_smoke.py's bf16 tolerance, so 1 is the
bound) with the count over it, the share of outputs that differ from r
rounded, and the largest difference in bf16 steps of the largest |r|
(2^-7 of its binade).
Needs a CUDA card.
"""

from __future__ import annotations

import math
import subprocess
import sys

import torch
import torch.nn.functional as F

from comat_tpu_torch.ops import conv3x3 as cv

# (H, C, Cout) of the 21 gated convs of the 512^2 decoder, at batch 4
SHAPES = [(128, 512, 512), (256, 512, 512), (256, 512, 256), (256, 256, 256),
          (512, 256, 256), (512, 256, 128), (512, 128, 128)]
BATCH = 4


def _dw64(x, dy):
    """dw summed in fp64 from the bf16 inputs, tap by tap."""
    B, H, W, C = x.shape
    g = dy.reshape(-1, dy.shape[-1]).double()
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = torch.empty(3, 3, C, dy.shape[-1], dtype=torch.float64, device=x.device)
    for di in range(3):
        for dj in range(3):
            out[di, dj] = xp[:, di:di + H, dj:dj + W, :].reshape(-1, C).double().T @ g
    return out


def _event_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(fn, reps: int = 10) -> dict:
    """{device kernel name: ms per call} from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if us > 0:
            out[ev.key] = us / 1e3 / reps
    return out


def _short(times: dict) -> str:
    named = {"conv3x3_dw_bf16_kernel": "wgmma pass", "conv3x3_dw_reduce": "reduce",
             "conv3x3_bf16_kernel": "kernel B"}
    parts = []
    for key, ms in sorted(times.items(), key=lambda kv: -kv[1]):
        name = next((v for k, v in named.items() if k in key), key[:60])
        parts.append(f"{name} {ms:.3f}")
    return ", ".join(parts)


def probe(Hs, C, Cout) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(BATCH, Hs, Hs, C, generator=gen, device="cuda").to(torch.bfloat16)
    dy = (torch.randn(BATCH, Hs, Hs, Cout, generator=gen, device="cuda")
          / math.sqrt(BATCH * Hs * Hs)).to(torch.bfloat16)
    w = (torch.randn(3, 3, C, Cout, generator=gen, device="cuda")
         / math.sqrt(9 * C)).to(torch.bfloat16)
    kernel = lambda: cv.conv3x3_dw(x, dy, torch.bfloat16)  # noqa: E731
    cudnn = lambda: torch.nn.grad.conv2d_weight(  # noqa: E731
        x.permute(0, 3, 1, 2), (Cout, C, 3, 3), dy.permute(0, 3, 1, 2), padding=1)
    splits, per = cv.dw_splits(BATCH, Hs, Hs, C, Cout, True)
    blocks = cv.dw_tiles(C, Cout)[0] * splits
    name = f"{BATCH}x{Hs}^2x{C}->{Cout}"
    k1, c1, c2, k2 = (_event_ms(fn) for fn in (kernel, cudnn, cudnn, kernel))
    print(f"{name} time: {splits} splits of {per} steps, {blocks} blocks "
          f"({blocks / 132:.2f} waves), workspace {splits * 36 * C * Cout / 1e6:.1f} MB; "
          f"kernel {(k1 + k2) / 2:.3f} ms ({k1:.3f}, {k2:.3f}; {_short(_kernel_ms(kernel))}); "
          f"cuDNN {(c1 + c2) / 2:.3f} ms ({c1:.3f}, {c2:.3f}; {_short(_kernel_ms(cudnn))}); "
          f"forward {_short(_kernel_ms(lambda: cv.conv3x3_fwd(x, w)))}", flush=True)

    r = _dw64(x, dy)
    rounded = r.to(torch.bfloat16).double()
    step = 2.0 ** (math.floor(math.log2(float(r.abs().max()))) - 7)
    cells = []
    for label, out in (("kernel", kernel()), ("plain", cv.conv3x3_dw_ref(x, dy, torch.bfloat16)),
                       ("cuDNN", cudnn().permute(2, 3, 1, 0))):
        out = out.double()
        ratio = (out - r).abs() / (1e-2 + 2.0 ** -7 * r.abs())
        cells.append(f"{label} {float(ratio.max()):.3f} ({int((ratio > 1).sum())} over), "
                     f"{float((out != rounded).double().mean()):.2e} not r rounded, "
                     f"{float((out - rounded).abs().max()) / step:.2f} steps")
    print(f"{name} rounding ({r.numel()} outputs): " + "; ".join(cells), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_conv_dw: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for shape in SHAPES:
        probe(*shape)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
