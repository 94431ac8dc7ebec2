"""The self-attention kernels' share of their roofline: the least time of
the step's self-attention over image tokens (`work/counts.flash_calls`:
the UNet's in pass 1, the replay and the captures, and the VAE's
mid-block; forward 4, dq 6 and dk/dv 8 B H S^2 d operations, inputs read
and outputs written once) over the device seconds of the kernels that
compute it in the profile, the kernels named below."""

from benchmark.work import counts

KERNELS = ("flash_fwd_", "flash_bwd_dq_", "flash_bwd_dkv_")


def read(trace):
    p = trace.profile
    if p is None or p.steps == 0:
        return None
    spent = sum(s for name, s in p.kernels.items() if any(k in name for k in KERNELS))
    if spent <= 0:
        return None
    bound = sum(counts.flash_bound_s(c) for c in trace.flash_calls) * p.steps
    return 100.0 * bound / spent
