"""Seconds of Grounded-SAM's host decode a step (`s_segment_host`), mean
over the window's steps."""

KEYS = ('s_segment_host',)


def read(trace):
    rows = [sum(s[k] for k in KEYS) for s in trace.steps if all(k in s for k in KEYS)]
    return sum(rows) / len(rows) if rows else None
