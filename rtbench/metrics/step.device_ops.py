"""Device operations a train step in the traced stretch: the nodes a replay
of the compiled step (`runtime.graph`) launches, reset and loss reads
included."""


def read(run):
    t = run.trace
    return t["n_ops"] / t["units"] if t and t["units"] else None
