"""Host seconds of Grounded-SAM's numpy decode a step (`h_segment_decode`:
the program's span "segment.decode", `decode_predictions` and
`decode_masks`, without the wait for the detectors' outputs or the masks'
upload), mean over the window's steps."""

KEYS = ('h_segment_decode',)


def read(trace):
    rows = [sum(s[k] for k in KEYS) for s in trace.steps if all(k in s for k in KEYS)]
    return sum(rows) / len(rows) if rows else None
