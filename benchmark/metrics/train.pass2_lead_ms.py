"""The replay's and the capture's lead a step (`lead_pass2_ms`): the median,
over the end marks of each replay segment's and capture op's forward and of
their backward, of the time from the host's queueing of the mark to the
device's reaching it, mean over the window's steps. Near 0 the device
waits on the host's launches; higher, the host runs ahead of the device."""

KEYS = ('lead_pass2_ms',)


def read(trace):
    rows = [sum(s[k] for k in KEYS) for s in trace.steps if all(k in s for k in KEYS)]
    return sum(rows) / len(rows) if rows else None
