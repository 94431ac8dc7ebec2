"""Which algorithm and math mode cuDNN runs for the library calls that
`chip_smoke.py` times beside the 3x3 conv kernels, in fp32.

    python -m comat_tpu_torch.tools.probe_conv_library

For each shape it calls `torch.nn.grad.conv2d_weight` (and, at a few
shapes, `F.conv2d` and `torch.nn.grad.conv2d_input`) on channels_last fp32
tensors in three modes: cuDNN with TF32 off (as `chip_smoke.py` sets it),
cuDNN with TF32 on, and cuDNN off (ATen's im2col and cuBLAS). It prints
the time (CUDA events), the rate of the direct count 2*B*H*W*9*C*Cout,
the error against the same call in fp64 (max |delta| over max |fp64|),
and the device kernels `torch.profiler` saw with their device time. Needs
a CUDA card; the port calls none of these library functions.
"""

from __future__ import annotations

import math
import subprocess
import sys

import torch
import torch.nn.functional as F

# (B, H, C, Cout): dw where the train step runs it (chip_smoke phase 4,
# batch 1) and three of the 512^2 decoder's shapes at batch 4
DW_SHAPES = [(1, 128, 512, 512), (1, 128, 512, 256), (1, 128, 256, 256),
             (1, 256, 256, 256), (1, 256, 256, 128), (1, 256, 128, 128),
             (4, 128, 512, 512), (4, 256, 256, 256), (4, 512, 128, 128)]
FWD_DX_SHAPES = [(1, 128, 512, 512), (4, 256, 256, 256)]
MODES = ("tf32_off", "tf32_on", "cudnn_off")


def _set_mode(mode: str) -> None:
    torch.backends.cudnn.enabled = mode != "cudnn_off"
    torch.backends.cudnn.allow_tf32 = mode == "tf32_on"


def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_kernels(fn):
    """[(kernel name, device microseconds)] of one call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if us > 0:
            out.append((ev.key, us))
    return out


def _calls(op, B, H, C, Cout, dtype):
    """The library call of `op` on seeded inputs of `dtype`."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(B, H, H, C, generator=g, device="cuda").to(dtype)
    w = (torch.randn(Cout, C, 3, 3, generator=g, device="cuda") / math.sqrt(9 * C)).to(dtype)
    dy = (torch.randn(B, H, H, Cout, generator=g, device="cuda")
          / math.sqrt(B * H * H)).to(dtype)
    # NCHW views of NHWC data (channels_last), as chip_smoke.py passes them
    x, dy = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    if op == "dw":
        return lambda: torch.nn.grad.conv2d_weight(x, (Cout, C, 3, 3), dy, padding=1)
    if op == "fwd":
        return lambda: F.conv2d(x, w, padding=1)
    return lambda: torch.nn.grad.conv2d_input((B, C, H, H), w, dy, padding=1)


def probe(op, B, H, C, Cout) -> None:
    _set_mode("tf32_off")
    want = _calls(op, B, H, C, Cout, torch.float64)().double()
    scale = float(want.abs().max())
    direct = 2.0 * B * H * H * 9 * C * Cout
    for mode in MODES:
        _set_mode(mode)
        fn = _calls(op, B, H, C, Cout, torch.float32)
        rel = float((fn().double() - want).abs().max()) / scale
        ms = _time_ms(fn)
        print(f"{op} {B}x{H}^2x{C}->{Cout} fp32 {mode}: {ms:.3f} ms, "
              f"{direct / ms / 1e9:.1f} TFLOP/s of the direct count, "
              f"error {rel:.2e} of max |fp64|", flush=True)
        for name, us in _device_kernels(fn):
            print(f"    {us:9.1f} us  {name[:160]}", flush=True)
    _set_mode("tf32_off")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_conv_library: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"cuDNN {torch.backends.cudnn.version()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in DW_SHAPES:
        probe("dw", *shape)
    for shape in FWD_DX_SHAPES:
        probe("fwd", *shape)
        probe("dx", *shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())
