"""The measured window: a loop's unit (a frame, a train step) run back to
back for the cell's seconds, and with `--trace 1` a stretch of units under
the profiler from the middle of the window on."""

from __future__ import annotations

import time


def drive(unit, seconds: float, sync, spans, *, trace_units: int = 0,
          align: int = 1) -> dict:
    """Run `unit(i)` for i = 0, 1, ... until `seconds` have passed since the
    first, then `sync()`. A unit returns its own latency in seconds, or None.
    With `trace_units`, once half the window has passed and at a unit index
    that is a multiple of `align`, the next `trace_units` units run under
    torch.profiler with the spans on, ending in a sync. Returns {"units",
    "wall_s", "latencies_s", and with a trace "trace": (profiler, first unit,
    units), "untraced_unit_s": the wall time a unit outside the stretch}."""
    lat = []
    traced, traced_wall = None, 0.0
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        if (trace_units and traced is None and i % align == 0
                and time.perf_counter() >= t0 + 0.5 * seconds):
            ta = time.perf_counter()
            traced = _traced(unit, i, trace_units, sync, spans)
            traced_wall = time.perf_counter() - ta
            i += trace_units
        else:
            lt = unit(i)
            if lt is not None:
                lat.append(lt)
            i += 1
        if time.perf_counter() >= deadline:
            break
    sync()
    wall = time.perf_counter() - t0
    out = {"units": i, "wall_s": wall, "latencies_s": lat}
    if traced is not None:
        out["trace"] = traced
        out["untraced_unit_s"] = (wall - traced_wall) / max(1, i - trace_units)
    return out


def _traced(unit, first: int, n: int, sync, spans):
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        spans.on = True
        try:
            with spans("window"):
                for i in range(first, first + n):
                    unit(i)
                sync()
        finally:
            spans.on = False
    return prof, first, n
