"""The program's own spans in a profiler trace: host ranges named
"octrt.<span>" (`utils.tracing`), with no device-side mirror. The
reduction (`lib/trace.py`) counts none of them as a device operation and
names no idle gap by them, so a trace that holds them reduces as the same
trace without them."""

import pytest

from rtbench.lib import trace


class _Event:
    """A profiler event as `trace.from_profiler` reads one (times in s)."""

    def __init__(self, name, device, start, end):
        from torch.autograd import DeviceType

        self.name = name
        self.device_type = DeviceType.CUDA if device == "cuda" else DeviceType.CPU
        self.time_range = type("Range", (), {"start": start * 1e6, "end": end * 1e6})


class _Profile:
    def __init__(self, events):
        self._events = [_Event(*e) for e in events]

    def events(self):
        return self._events


HARNESS = [("rtbench.window", "cpu", 0.0, 10.0), ("rtbench.frame.issue", "cpu", 1.5, 5.0),
           ("rtbench.frame.fence", "cpu", 5.5, 8.0),
           ("rtbench.frame.issue", "cuda", 1.6, 4.9)]  # its device-side annotation
OPS = [("k_a", "cuda", 0.0, 1.0), ("k_b", "cuda", 0.5, 2.0),
       ("fwd_tiled_kernel", "cuda", 3.0, 4.0), ("k_a", "cuda", 6.0, 7.0),
       ("k_a", "cuda", 9.5, 12.0)]
PROGRAM = [("octrt.frame.bin", "cpu", 1.6, 3.4), ("octrt.frame.bin.host_read", "cpu", 2.2, 2.8),
           ("octrt.frame.gather", "cpu", 3.5, 5.0)]


def test_program_spans_leave_the_reduction_as_it_was():
    plain = trace.from_profiler(_Profile(HARNESS + OPS), 2, "window")
    traced = trace.from_profiler(_Profile(HARNESS + OPS + PROGRAM), 2, "window")
    assert traced["n_ops"] == plain["n_ops"] == 5
    for key in ("busy_s", "window_s"):
        assert traced[key] == pytest.approx(plain[key])
    for key in ("by_name", "idle_by_span"):
        assert traced[key] == pytest.approx(plain[key])
    assert traced["launches"] == plain["launches"]
    assert plain["idle_by_span"] == pytest.approx({"frame.issue": 3.0, "window": 2.5})
