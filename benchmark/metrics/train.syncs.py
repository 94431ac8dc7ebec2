"""Reads that block on the device a step (`n_syncs`: the program's count of
`PhaseClock.sync` spans, one around each blocking read at a named site,
the step's closing wait among them), mean over the window's steps."""

KEYS = ('n_syncs',)


def read(trace):
    rows = [sum(s[k] for k in KEYS) for s in trace.steps if all(k in s for k in KEYS)]
    return sum(rows) / len(rows) if rows else None
