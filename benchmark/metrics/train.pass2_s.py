"""Device seconds of the replay and the capture a step (`s_pass2`: the K
replayed UNet calls and the capture forwards, forward and backward),
mean over the window's steps."""

KEYS = ('s_pass2',)


def read(trace):
    rows = [sum(s[k] for k in KEYS) for s in trace.steps if all(k in s for k in KEYS)]
    return sum(rows) / len(rows) if rows else None
