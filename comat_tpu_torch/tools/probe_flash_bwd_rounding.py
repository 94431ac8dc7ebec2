"""How far the bf16 flash-attention backward lands from an fp64 computation
of the same rounding points, for the kernels and two plain versions.

    python -m comat_tpu_torch.tools.probe_flash_bwd_rounding

The backward rounds an intermediate to bf16: dS (and P) before the dq, dk
and dv products. Where two implementations sum S = q^ k^T or dP = dO v^T
in another order, a dS near a rounding midpoint goes to neighbouring bf16
values, and one step of a large dS, times k or q^, shows in the output.
For each shape of the train path (and chip_smoke's ragged one) this
prints, for dq, dk and dv, the largest |x - y| / (1e-2 + 2^-7 |y|) (the
bf16 tolerance of chip_smoke.py, so 1 is the bound) and how many outputs
pass it, for these pairs:
- kernel / plain: the kernels against `flash_attention_bwd_ref`, whose
  products take bf16 operands with fp32 sums through cuBLAS's bf16 GEMM
  on the tensor cores (JAX's `dot_general(..., preferred_element_type=
  f32)`);
- kernel / sgemm: the kernels against the same arithmetic with the
  operands widened to fp32 and cuBLAS's fp32 GEMM (TF32 off);
- each of the three against fp64 sums with the same rounding points.
Inputs as chip_smoke.py draws them (dO scaled by sqrt(Sq)), seed 1.
Needs a CUDA card.
"""

from __future__ import annotations

import math
import subprocess
import sys

import torch

from comat_tpu_torch.ops import flash_attention as fa

SHAPES = [(8, 8, 4096, 4096, 40), (8, 8, 1024, 1024, 80), (8, 8, 256, 256, 160),
          (4, 1, 4096, 4096, 512), (1, 8, 1000, 1100, 80)]


def _bwd(q, k, v, do, lse, dvec, dtype):
    """The plain backward's arithmetic with every product summed in
    `dtype` (fp32 on the CUDA cores, or fp64) from the bf16 rounding
    points."""
    d = q.shape[-1]
    qs = (q * torch.tensor(fa._scale(d, q.dtype), dtype=q.dtype)).to(dtype)
    p = torch.exp(qs @ k.to(dtype).transpose(-1, -2) - lse.to(dtype)[..., None])
    ds = p * (do.to(dtype) @ v.to(dtype).transpose(-1, -2) - dvec.to(dtype)[..., None])
    ds = ds.to(q.dtype).to(dtype)
    return ((ds @ k.to(dtype)) * (1.0 / math.sqrt(d))).to(q.dtype), \
        (ds.transpose(-1, -2) @ qs).to(q.dtype), \
        (p.to(q.dtype).to(dtype).transpose(-1, -2) @ do.to(dtype)).to(q.dtype)


def _ratio(x, y):
    r = (x.float() - y.float()).abs() / (1e-2 + 2.0 ** -7 * y.float().abs())
    return float(r.max()), int((r > 1).sum())


def probe(shape) -> None:
    B, H, Sq, Skv, d = shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(B, S, H, d, generator=gen, device="cuda")
                   .transpose(1, 2).to(torch.bfloat16) for S in (Sq, Skv, Skv, Sq))
    do = (do.float() * math.sqrt(Sq)).to(torch.bfloat16)
    o, lse = fa.flash_attention(q, k, v, want_lse=True)
    dvec = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, dvec)
    outs = {"kernel": fa.flash_attention_bwd(*args), "plain": fa.flash_attention_bwd_ref(*args),
            "sgemm": _bwd(*args, torch.float32)}
    pairs = [("kernel", "plain"), ("kernel", "sgemm"), ("kernel", "fp64"),
             ("plain", "fp64"), ("sgemm", "fp64")]
    worst = {(a, b, g): (0.0, 0) for a, b in pairs for g in range(3)}
    step = max(1, 64 * 1024 * 1024 // (Sq * Skv))   # heads per fp64 chunk
    for b0 in range(B):
        for h0 in range(0, H, step):
            sl = (slice(b0, b0 + 1), slice(h0, h0 + step))
            ref = {"fp64": _bwd(*(t[sl] for t in args), torch.float64)}
            for a, b in pairs:
                for g in range(3):
                    y = ref[b][g] if b == "fp64" else outs[b][g][sl]
                    r, n = _ratio(outs[a][g][sl], y)
                    w = worst[(a, b, g)]
                    worst[(a, b, g)] = (max(w[0], r), w[1] + n)
    total = B * H * max(Sq, Skv) * d
    for g, name in enumerate(("dq", "dk", "dv")):
        cells = ", ".join(f"{a}/{b} {worst[(a, b, g)][0]:.3f} "
                          f"({worst[(a, b, g)][1]} over)" for a, b in pairs)
        print(f"{list(shape)} {name} (<= {total} outputs): {cells}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_flash_bwd_rounding: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in SHAPES:
        probe(shape)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
