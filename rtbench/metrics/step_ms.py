"""The window's wall time, which ends with a synchronise, over the train
steps completed in it (host clock)."""


def read(run):
    w = run.window
    return 1e3 * w["wall_s"] / w["units"] if w.get("units") else None
