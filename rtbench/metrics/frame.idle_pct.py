"""The card's idle share of the traced stretch of frames: 100 times one
minus the union of the device operations' intervals over the stretch's
wall time (profiler clock)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
