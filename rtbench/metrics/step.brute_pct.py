"""The share of the compiled train step's replays, over the whole run, whose
soft forward took the brute branch (B6/B7: a tile list overflowed its K
cap): the card's counter of that cond (`cond.soft_tiled.fwd.brute`, added
to where the graph sets its branches) over the replays of the step (the
program's counter `graph.replays.train step`), in percent."""


def read(run):
    try:
        from opencl_ray_tracer_tpu_torch.utils import tracing
    except ImportError:  # a program without its recorder
        return None
    c = run.memo("program_snapshot", tracing.snapshot)["counters"]
    brute, replays = c.get("cond.soft_tiled.fwd.brute"), c.get("graph.replays.train step")
    if brute is None or not replays:
        return None
    return 100.0 * brute / replays
