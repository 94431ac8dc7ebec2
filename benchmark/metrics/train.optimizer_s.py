"""Device seconds of the generator's clipped AdamW a step (`s_optimizer`),
mean over the window's steps."""

KEYS = ('s_optimizer',)


def read(trace):
    rows = [sum(s[k] for k in KEYS) for s in trace.steps if all(k in s for k in KEYS)]
    return sum(rows) / len(rows) if rows else None
