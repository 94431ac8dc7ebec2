"""Pass 1's guided UNet calls that replayed a CUDA graph, over all of them
(`pass1_graph_share`: the program's tallies of graph replays and eager
calls on the step's clock), mean over the window's steps. 1 where every
call of the window replayed; 0 where none could (or none took a graph)."""

KEYS = ('pass1_graph_share',)


def read(trace):
    rows = [sum(s[k] for k in KEYS) for s in trace.steps if all(k in s for k in KEYS)]
    return sum(rows) / len(rows) if rows else None
