"""Reduce a profiler trace of a stretch of the window to what the per-layer
metrics read: the device operations, the card's busy time (the union of the
operations' intervals), the idle gaps named by the harness's span the host
was in, and time and launches by operation name."""

from __future__ import annotations

import re
from typing import Optional

from rtbench.lib.spans import PREFIX


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(device_ops, spans, window, units: int) -> dict:
    """`device_ops`: (name, start, end) in seconds; `spans`: (name, start,
    end) of the harness's spans; `window`: (start, end) of the stretch on the
    same clock; `units`: frames or steps in it. Operations are clipped to
    the window."""
    w0, w1 = window
    ops = [(n, max(a, w0), min(b, w1)) for n, a, b in device_ops
           if b > w0 and a < w1]
    busy_iv = _union([(a, b) for _, a, b in ops if b > a])
    busy = sum(b - a for a, b in busy_iv)
    by_name, launches = {}, {}
    for n, a, b in ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
        launches[n] = launches.get(n, 0) + 1
    gaps, t = [], w0
    for a, b in busy_iv:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    idle = {}
    for a, b in gaps:
        idle_name = host_span(spans, 0.5 * (a + b))
        idle[idle_name] = idle.get(idle_name, 0.0) + (b - a)
    return {"units": units, "window_s": w1 - w0, "busy_s": busy,
            "n_ops": len(ops), "by_name": by_name, "launches": launches,
            "idle_by_span": idle}


def host_span(spans, t: float) -> str:
    """The innermost harness span holding time t, or "harness" for host work
    between them."""
    best: Optional[tuple] = None
    for n, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (n, a, b)
    return best[0][len(PREFIX):] if best else "harness"


def from_profiler(prof, units: int, window_span: str) -> dict:
    """`reduce` over a torch.profiler run: the device's operations and the
    harness's spans; the window is the span named `window_span`."""
    from torch.autograd import DeviceType

    dev, spans = [], []
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.name.startswith(PREFIX):
            # a span shows on the host and, as a user annotation, on the
            # device's timeline too: only the host's is a span
            if e.device_type != DeviceType.CUDA:
                spans.append((e.name, a, b))
        elif e.device_type == DeviceType.CUDA:
            dev.append((e.name, a, b))
    win = [(a, b) for n, a, b in spans if n == PREFIX + window_span]
    if not win:
        raise RuntimeError(f"the trace holds no span {window_span!r}")
    return reduce(dev, spans, win[0], units)


def kernel(red: dict, function: str):
    """(seconds, launches) of the device operations whose name holds the
    kernel function `function` as a whole identifier, demangled or mangled
    (a length before it, a type code after)."""
    pat = re.compile(rf"(?<![A-Za-z_]){re.escape(function)}(?![a-z0-9_])")
    secs, n = 0.0, 0
    for name, s in red["by_name"].items():
        if pat.search(name):
            secs += s
            n += red["launches"][name]
    return secs, n


def breakdown(red: dict, top: int = 10) -> dict:
    ops = sorted(red["by_name"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(red["idle_by_span"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
