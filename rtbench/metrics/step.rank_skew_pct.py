"""How far equal row blocks leave the cards waiting on the slowest: every
rank profiles the same traced stretch of steps and reports its device
busy time a step less its time in NCCL's kernels (`loops/fit_rows.py`
`rank_times`); 100 times (largest - least) over the largest, across the
ranks, in percent."""


def read(run):
    times = run.inputs.get("rank_times")
    if not times or any(t is None or t[0] is None for t in times):
        return None
    own = [t[0] for t in times]
    if max(own) <= 0:
        return None
    return 100.0 * (max(own) - min(own)) / max(own)
