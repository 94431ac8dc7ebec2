"""Host seconds of the trainer's batch a step (`h_batch`: the program's
span "batch" around `Trainer._batch`, which covers the tokenizers, the
attribute parse, the latent store and the batch's arrays), mean over the
window's steps."""

KEYS = ('h_batch',)


def read(trace):
    rows = [sum(s[k] for k in KEYS) for s in trace.steps if all(k in s for k in KEYS)]
    return sum(rows) / len(rows) if rows else None
