"""Timing — the reference's PerformanceCounter + DeltaTime subsystems.

PerformanceCounter (misc/PerformanceCounter.cpp:30-64) wraps Win32 QPC and
returns elapsed MICROSECONDS; same API here over the monotonic
`time.perf_counter_ns` clock, with the device-aware benchmark discipline
the reference lacks: `time_fn` fences the card's work
(`torch.cuda.synchronize`) so that asynchronous launches and the kernel
build of a first call do not pollute measurements.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List

import torch


def now_ns() -> int:
    """The monotonic clock in nanoseconds (`time.perf_counter_ns`)."""
    return time.perf_counter_ns()


class PerformanceCounter:
    """start/stop microsecond counter (PerformanceCounter.cpp API shape)."""

    def __init__(self) -> None:
        self._start: int | None = None
        self.elapsed_us: float = 0.0

    def start_counter(self) -> None:
        self._start = now_ns()

    def stop_counter(self) -> float:
        if self._start is None:
            raise RuntimeError("stopCounter called before startCounter")
        self.elapsed_us = (now_ns() - self._start) / 1e3
        self._start = None
        return self.elapsed_us


class DeltaTime:
    """Frame-to-frame seconds (misc/DeltaTime.cpp:21-26)."""

    def __init__(self) -> None:
        self._last = now_ns()
        self.delta = 0.0

    def update(self) -> float:
        t = now_ns()
        self.delta = (t - self._last) / 1e9
        self._last = t
        return self.delta


class SimpleTimer:
    """Countdown timer (misc/Utility.h:188-307 role)."""

    def __init__(self, duration_s: float):
        self.duration = duration_s
        self.restart()

    def restart(self) -> None:
        self._t0 = now_ns()

    @property
    def expired(self) -> bool:
        return (now_ns() - self._t0) / 1e9 >= self.duration


def fence(out) -> None:
    """Wait until the card has produced `out`: one torch.cuda.synchronize
    for every card that a tensor of `out` (a tensor, or a tuple / list of
    them) lies on; nothing for CPU tensors."""
    items = out if isinstance(out, (tuple, list)) else (out,)
    for dev in {t.device for t in items
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def time_fn(
    fn: Callable[[], object],
    iters: int = 10,
    warmup: int = 2,
    batches: int = 4,
) -> Dict[str, float]:
    """Time a device computation: warm up (the kernel build), then
    `batches` batches of `iters` back-to-back calls with ONE fence per
    batch. Saturating the queue with `iters` launches and fencing once
    amortises the launch overhead and measures the card's throughput
    (in-order execution on one stream). Returns stats in microseconds per
    call (the reference's display unit, MainState.cpp:894-903)."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn()
    fence(out)

    samples: List[float] = []
    for _ in range(batches):
        t0 = now_ns()
        for _ in range(iters):
            out = fn()
        fence(out)
        samples.append((now_ns() - t0) / 1e3 / iters)
    return {
        "mean_us": statistics.fmean(samples),
        "median_us": statistics.median(samples),
        "min_us": min(samples),
        "max_us": max(samples),
        "stdev_us": statistics.pstdev(samples) if len(samples) > 1 else 0.0,
        "iters": float(iters * batches),
    }
