"""The train step's gradient all-reduce (`parallel.mesh.Mesh.all_reduce`,
one a step, captured in the step's CUDA graph), in ms a step: the least,
over the ranks, of a rank's device time in NCCL's kernels in the traced
stretch (`loops/fit_rows.py` `rank_times`). The kernel waits in place for
the other ranks, so the slowest rank, which waits least, reads the nearest
to the exchange itself; the other ranks' readings, rank 0's among them,
add their wait for it and are in the run's notes."""


def read(run):
    times = run.inputs.get("rank_times")
    if not times or any(t is None or t[1] is None for t in times):
        return None
    return 1e3 * min(t[1] for t in times)
