"""Timing on the card with CUDA events.

PyTorch returns from a call before the device has finished it, so a host
clock without a synchronise measures the enqueue. `call_times_ms` brackets
each call with a pair of CUDA events and reads the device's own clock; the
host's work inside the call (binning, table gathers, the launch) counts,
as it does for a user who calls the function in a loop. `back_to_back_ms`
brackets a whole run of calls instead: once the host runs ahead of the
device this is the device time per call. `device_ms` queues the run behind
a spin on the card, so that it is the device time per call even where the
wrapper's host work outlasts its kernel.

`device_frame_time_us` and `device_step_time_us` are the JAX package's
measurement (its bench_util.py): N frames or steps inside ONE compiled
program, each with a different camera origin (o0 + e * 1e-3 for e in
linspace(0, 0.125, N): identical work that cannot be merged), each consumed
into a scalar carry, replayed `reps` times (median of a host clock around a
replay and a synchronise), at two frame counts; the two-point slope cancels
the per-program constant. Here the program is a CUDA graph
(runtime/graph.py) and the slope is per frame of a replay: the device's time
plus whatever the graph's launches cost, with no Python in it.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Iterable, List, Tuple


def median_spread(samples: Iterable[float]) -> Tuple[float, float, float]:
    """(median, min, max) of the measurements; the true median (the mean of
    the two middle values on even lengths). Raises ValueError on none."""
    s = sorted(samples)
    if not s:
        raise ValueError("median_spread needs at least one measurement")
    return statistics.median(s), s[0], s[-1]


def _require_card():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: timing runs on the card")
    return torch


def call_times_ms(fn: Callable[[], object], n: int = 50,
                  warmup: int = 3) -> List[float]:
    """Milliseconds of each of n calls of fn (a frame or a train step), a
    pair of CUDA events around every call, after `warmup` untimed calls."""
    torch = _require_card()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def back_to_back_ms(fn: Callable[[], object], n: int = 100,
                    spin_cycles: int = 0) -> float:
    """Milliseconds per call over n calls made back to back between two
    CUDA events, the card first set spinning for `spin_cycles` of its clock
    so that the host can queue the calls ahead of it."""
    torch = _require_card()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin_cycles:
        torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn: Callable[[], object], n: int = 50) -> float:
    """Milliseconds of device time per call: n calls queued behind a spin of
    ~0.1 s on the card, so that the host's share of a call does not count
    (back to back, a call whose wrapper outlasts its kernel reads as the
    wrapper)."""
    return back_to_back_ms(fn, n, spin_cycles=200_000_000)


class SlopeError(RuntimeError):
    """A two-point slope that is not positive: t(N2) <= t(N1), the
    measurement failed (noise swamped the per-frame cost). The JAX package
    returns a 1e-3 us sentinel there; the port raises, as `median_spread`
    does on no samples."""


def _scan_total_us(render_fn: Callable, camera, n_frames: int, reps: int,
                   scalar_body: bool) -> float:
    """Median microseconds of one replay of n_frames frames captured as one
    CUDA graph: frame i renders through the camera with origin o0 + e_i *
    1e-3, e = linspace(0, 0.125, n_frames), and adds its probe (the frame's
    pixels (5, 5) and (-1, -1), or the scalar a scalar body returns) to a
    carry on the card."""
    torch = _require_card()
    from opencl_ray_tracer_tpu_torch.runtime.graph import capture

    dev = camera.o0.device
    eps = torch.linspace(0.0, 0.125, n_frames, dtype=torch.float32, device=dev)

    def run():
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n_frames):
            out = render_fn(dataclasses.replace(camera, o0=camera.o0 + eps[i] * 1e-3))
            if scalar_body:
                acc = acc + out.to(torch.float32)
            elif out.dim() == 2:  # packed int32 words
                acc = acc + ((out[5, 5] & 0xFF) + (out[-1, -1] & 0xFF)).float()
            else:
                acc = acc + out[5, 5, 0].float() + out[-1, -1, 1].float()
        return acc

    with torch.cuda.device(dev):
        graph, _ = capture(run, warmup=1, name=f"{n_frames} frames")
        graph.replay()
        torch.cuda.synchronize()
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter_ns()
            graph.replay()
            torch.cuda.synchronize()
            samples.append((time.perf_counter_ns() - t0) / 1e3)
    return statistics.median(samples)


def _slope_us(render_fn: Callable, camera, n_frames: int, reps: int,
              scalar_body: bool, total_us: Callable = _scan_total_us) -> float:
    """(t(n_frames) - t(n1)) / (n_frames - n1) over `total_us`, with the JAX
    package's baseline n1 = max(min(N // 2, max(N // 8, 4)), 1); a request
    too small for a slope gives t(N) / N. Raises SlopeError where the slope
    is not positive."""
    n1 = max(min(n_frames // 2, max(n_frames // 8, 4)), 1)
    if n_frames <= n1:  # degenerate request: no slope to take
        return total_us(render_fn, camera, n_frames, reps, scalar_body) / max(n_frames, 1)
    t1 = total_us(render_fn, camera, n1, reps, scalar_body)
    t2 = total_us(render_fn, camera, n_frames, reps, scalar_body)
    slope = (t2 - t1) / (n_frames - n1)
    if slope <= 0.0:
        raise SlopeError(f"invalid slope {slope:.3f} us/frame: t({n1}) = {t1:.1f} "
                         f"us, t({n_frames}) = {t2:.1f} us")
    return slope


def device_frame_time_us(render_fn: Callable, camera, n_frames: int = 100,
                         reps: int = 5) -> float:
    """Microseconds per frame of render_fn(camera) -> framebuffer, the
    two-point slope of one-graph runs (see the module docstring). render_fn
    must not read the card on the host (a CUDA graph captures it)."""
    return _slope_us(render_fn, camera, n_frames, reps, scalar_body=False)


def device_step_time_us(step_fn: Callable, camera, n_frames: int = 30,
                        reps: int = 5) -> float:
    """Microseconds per step of step_fn(camera) -> scalar (a loss whose
    gradients were consumed into it, or a train step's loss), as
    `device_frame_time_us`."""
    return _slope_us(step_fn, camera, n_frames, reps, scalar_body=True)
