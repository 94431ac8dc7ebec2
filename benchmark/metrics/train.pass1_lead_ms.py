"""Pass 1's lead a step (`lead_pass1_ms`): the median, over the end marks of
its guided UNet calls, of the time from the host's queueing of the mark to
the device's reaching it, mean over the window's steps. Near 0 the device
waits on the host's launches; higher, the host runs ahead of the device."""

KEYS = ('lead_pass1_ms',)


def read(trace):
    rows = [sum(s[k] for k in KEYS) for s in trace.steps if all(k in s for k in KEYS)]
    return sum(rows) / len(rows) if rows else None
