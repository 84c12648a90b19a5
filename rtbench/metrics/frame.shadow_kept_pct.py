"""The share of the pinhole shadow rows that B1's warps kept when they culled
them against their own hit points, over the whole run: the card's counters
`b1.shadow_rows_kept` over `b1.shadow_rows` (the rows of each light whose
list a warp culled: longer than a warp, in a warp with a lit pixel), in
percent. A program without the cull, or a run whose lists never engage it,
reads nothing."""


def read(run):
    try:
        from opencl_ray_tracer_tpu_torch.utils import tracing
    except ImportError:  # a program without its recorder
        return None
    c = run.memo("program_snapshot", tracing.snapshot)["counters"]
    rows = c.get("b1.shadow_rows")
    kept = c.get("b1.shadow_rows_kept")
    if kept is None or not rows:  # no cull, or none engaged
        return None
    return 100.0 * kept / rows
