"""Seconds a step spends outside the device clock's span: the wall time
of the whole `Trainer.train_one` (timed from outside, to its synchronise)
minus the step's `s_step`, mean over the window's steps. The host's batch
assembly (tokenizers, attribute parse, latent store) lands here."""


def read(trace):
    rows = [w - s["s_step"] for w, s in zip(trace.walls, trace.steps) if "s_step" in s]
    return sum(rows) / len(rows) if rows else None
