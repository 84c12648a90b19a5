"""The mean frame time of the traced run's window, issue of the first frame
to the fence of the last, over the frames completed, leaving out the traced
stretch, which the profiler slows (host clock)."""


def read(run):
    w = run.window
    if "untraced_unit_s" in w:
        return 1e3 * w["untraced_unit_s"]
    return 1e3 * w["wall_s"] / w["units"] if w.get("units") else None
