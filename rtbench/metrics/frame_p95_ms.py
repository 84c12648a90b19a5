"""The 95th percentile of the frames' times, each from its issue to its
fence, over every frame of the window (nearest rank; host clock)."""

import math


def read(run):
    lat = sorted(run.window.get("latencies_s", []))
    if not lat:
        return None
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
