"""Device seconds of pass 1 a step (`s_pass1` of the step's metrics: the
50 guided UNet calls and the text encoding), mean over the window's steps."""

KEYS = ('s_pass1',)


def read(trace):
    rows = [sum(s[k] for k in KEYS) for s in trace.steps if all(k in s for k in KEYS)]
    return sum(rows) / len(rows) if rows else None
