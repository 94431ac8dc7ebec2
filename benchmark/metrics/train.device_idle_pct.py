"""Share of the profiled interval (whole steps of the window) in which no
kernel, copy or set runs on the card, from the profiler's trace."""


def read(trace):
    p = trace.profile
    if p is None or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
