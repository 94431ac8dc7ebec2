"""The whole step's share of the card's bf16 peak: the model operations of
the profiled steps (`work/counts.train_step_flops`, counted from the
configuration and the recipe) over their seconds (the profiled interval)
at 989 TFLOP/s."""

from benchmark.work import counts


def read(trace):
    p = trace.profile
    if p is None or p.window_s <= 0 or p.steps == 0:
        return None
    ops = sum(trace.step_flops.values()) * p.steps
    return 100.0 * ops / (p.window_s * counts.PEAK_FLOPS["bfloat16"])
