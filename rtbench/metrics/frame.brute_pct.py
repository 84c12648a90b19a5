"""The share of the compiled hard frame's replays, over the whole run, that
took the brute branch (B3: a tile list overflowed the config's K caps): the
card's counter of that cond (`cond.fwd_tiled.frame.brute`, added to where
the graph sets its branches) over the replays of the frame (the program's
counter `graph.replays.render_tiled_fixed`), in percent."""


def read(run):
    try:
        from opencl_ray_tracer_tpu_torch.utils import tracing
    except ImportError:  # a program without its recorder
        return None
    c = run.memo("program_snapshot", tracing.snapshot)["counters"]
    brute = c.get("cond.fwd_tiled.frame.brute")
    replays = c.get("graph.replays.render_tiled_fixed")
    if brute is None or not replays:  # a program whose cond names no site
        return None
    return 100.0 * brute / replays
