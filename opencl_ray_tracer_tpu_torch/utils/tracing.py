"""The port's recorder of spans and counters at its layer boundaries.

A span (`span(name)`) marks a layer's stretch of host time: binning and
gathering a frame, replaying a compiled step. Spans are recorded only while
tracing is on: while a torch profiler records, or inside `recording()`.
Otherwise `span` tests one flag and returns a shared null context, which
allocates and records nothing. When on, a span adds its time on
`time.perf_counter_ns` to its name's count, total and self time (its time
less that of the spans directly inside it), and keeps (name, start, end,
parent name) among the last `RECENT` spans; the spans open now are the
thread's own. While a profiler records, a span also opens a profiler range
"octrt." + name, so that the profiler's trace holds it on the clock of the
device's operations. The range is a host operation (`_RecordFunctionFast`,
category cpu_op), not a user annotation (`torch.profiler.record_function`):
the profiler mirrors a user annotation on the device's timeline as a range
over the kernels launched inside it, which a reduction of the trace would
count as one more device operation and as busy time. A torch without
`_RecordFunctionFast` records the span and opens no range. Under a
profiler, the host time of every span includes the profiler's own cost
(CUPTI's, per launch): read span times as shares of a traced stretch.

A counter (`count(name, n)`) is always on, a dict add: kernel launches,
graph replays, set-up seconds. A device counter lives in a tensor that the
card adds to inside a CUDA graph, where no host code runs (the branches a
captured `runtime.graph.cond` takes); `snapshot` and `counter` read it on
the host, which waits for the card, so neither is called inside a frame or
a step.

Span and counter names, by layer:
- hard frame (`models.renderer.render` -> `kernels.fwd_tiled`): spans
  `frame.pack` (`Scene.pack`), `frame.bin` (`bin_for_config`, re-bins
  included, or the binning of one run of `render_tiled`'s frame),
  `frame.bin.host_read` (`bin_for_config`'s overflow read), `frame.gather`
  (`kernel_inputs`), all four eager (a replayed frame runs them only in its
  capture), and `frame.replay.host_read` (`render_tiled`'s overflow read
  after each run of the frame, replayed or eager); counters
  `frame.replayed`, `frame.eager` (`render_tiled`'s frames, each in one of
  them), `frame.rebinned` (its frames whose overflow flag read true),
  `frame.runs` (its runs of the whole frame at a K pair, eager or replayed:
  one a frame, and one more a doubling of the caps);
- compiled path (`runtime.graph`, `parallel.train`): span `graph.replay`,
  counters `graph.replays.<capture name>`, `graph.capture_s` (warm-up and
  capture), device counters `cond.soft_tiled.fwd.brute` (replays whose
  soft forward took the brute branch: `runtime.graph.cond(..., site=)`)
  and `cond.fwd_tiled.frame.brute` (replays of the compiled hard frame,
  `fwd_tiled._render_tiled_jit`, that took the brute branch);
- rank mesh (`parallel.mesh.Mesh.all_reduce`, `parallel.train`): span
  `mesh.all_reduce` (each call, a capture's included), counters
  `mesh.all_reduces` and `mesh.all_reduce_bytes` (each exchange that runs:
  an eager call, or a replay of a captured mesh step, which adds the bytes
  its capture recorded), `mesh.captured_bytes` (the bytes of exchanges
  recorded into captures); a mesh without a process group exchanges
  nothing;
- set-up: `train.optimizer_s` (the optimizer's construction),
  `kernels.build_s` (nvcc);
- kernels: `launch.B1` (B1/B2, launched from the host outside a capture:
  a captured B1 runs at each replay, `graph.replays.<capture name>`),
  device counters `b1.shadow_rows` and `b1.shadow_rows_kept` (B1/B2 under a
  pinhole camera with shadows, eager or replayed: the shadow rows of the
  lights whose list its warps culled against their hit points, and the
  rows they kept; made by the first launch outside a capture),
  `launch.bin` (the binning kernels of `fwd_tiled.bin_scene`, one a call),
  `launch.gather` (`fwd_tiled.kernel_inputs`' gather kernel) and
  `launch.bin_soft` (the soft binning kernels of `soft_tiled._bin_soft`,
  one a call), counted as B1 is, `launch.B3` ... `launch.B7`,
  `launch.B4_finals`, `launch.B5_finals`; device counters `b3.px` and
  `b3.hit_px` (B3, `kernels/fwd.py` `brute_kernel`, eager or replayed: the
  pixels each launch that runs works, and those that hit something; made
  by the first launch outside a capture);
- app shell (`app.main_state.MainState.run_trace`): span `app.readback`
  (the frame's copy to the host, inside the timed trace), counters
  `app.readbacks` and `app.readback_bytes`.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Deque, Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

PREFIX = "octrt."
RECENT = 4096  # closed spans kept as (name, start_ns, end_ns, parent name)

_NULL = contextlib.nullcontext()
_recording = 0          # depth of `recording()` blocks
_totals: Dict[str, List[int]] = {}  # name -> [count, total_ns, child_ns]
_recent: Deque[Tuple[str, int, int, Optional[str]]] = collections.deque(maxlen=RECENT)
_local = threading.local()  # .open: this thread's open spans, innermost last
_counters: Dict[str, float] = {}
_device: Dict[str, List[torch.Tensor]] = {}  # device counters' int64 slots
# device_counters' blocks, by their names and device
_blocks: Dict[Tuple[Tuple[str, ...], torch.device], torch.Tensor] = {}
_range_op = None        # _RecordFunctionFast, False where torch lacks it


def _open() -> list:
    try:
        return _local.open
    except AttributeError:
        _local.open = []
        return _local.open


def _profiler_range(name: str):
    """An entered profiler range (a host op) named `name`, or None."""
    global _range_op
    if _range_op is None:
        try:
            from torch._C._profiler import _RecordFunctionFast
        except ImportError:
            _RecordFunctionFast = False
        _range_op = _RecordFunctionFast
    if not _range_op:
        return None
    r = _range_op(name)
    r.__enter__()
    return r


class _Span:
    __slots__ = ("name", "start", "child_ns", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.range = _profiler_range(PREFIX + self.name)
        _open().append(self)
        self.child_ns = 0
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = _open()
        stack.pop()
        took = end - self.start
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.child_ns += took
        t = _totals.setdefault(self.name, [0, 0, 0])
        t[0] += 1
        t[1] += took
        t[2] += self.child_ns
        _recent.append((self.name, self.start, end,
                        None if parent is None else parent.name))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager over a layer's stretch of host time (see the
    module's docstring); one shared null context while tracing is off."""
    if _profiler._is_profiler_enabled or _recording:
        return _Span(name)
    return _NULL


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Tracing on for the block, with no profiler (tests, and the cost of
    tracing measured against the same work with it off)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def count(name: str, n: float = 1) -> None:
    """Add n to a host counter."""
    _counters[name] = _counters.get(name, 0) + n


def device_counter(name: str, device, make: bool = True) -> Optional[torch.Tensor]:
    """The int64 slot of the device counter `name` on `device`, made (zero)
    at the first call for that device; with `make` False, None where it was
    not made. Make it outside a CUDA graph's capture: a fill captured there
    would clear the counter at every replay."""
    dev = torch.device(device)
    for slot in _device.get(name, ()):
        if slot.device == dev:
            return slot
    if not make:
        return None
    slot = torch.zeros(1, dtype=torch.int64, device=dev)
    _device.setdefault(name, []).append(slot)
    return slot


def device_counters(names: Tuple[str, ...], device,
                    make: bool = True) -> Optional[torch.Tensor]:
    """The device counters `names` on `device` as the int64 slots of one
    tensor (len(names),), for a kernel that takes them as one pointer: made
    (zero) together at the first call for that device, each then read and
    zeroed as `device_counter`'s; with `make` False, None where they were
    not made. A name already made apart from this block raises ValueError.
    Make them outside a CUDA graph's capture."""
    dev = torch.device(device)
    block = _blocks.get((names, dev))
    if block is not None or not make:
        return block
    apart = [n for n in names if device_counter(n, dev, make=False) is not None]
    if apart:
        raise ValueError(f"device counters {apart} on {dev} were made apart "
                         f"from the block {names}")
    block = torch.zeros(len(names), dtype=torch.int64, device=dev)
    for i, n in enumerate(names):
        _device.setdefault(n, []).append(block[i : i + 1])
    _blocks[(names, dev)] = block
    return block


def counter(name: str) -> float:
    """A counter's value (0 where nothing counted it); a device counter is
    summed over its devices on the host."""
    return _counters.get(name, 0) + sum(int(s.item()) for s in _device.get(name, ()))


def snapshot() -> dict:
    """{"spans": {name: {"count", "total_s", "self_s"}}, "counters": {name:
    value}} of what was recorded since the last `reset`. A span's self time
    is its time less the time of the spans directly inside it; spans still
    open are left out. Device counters are read on the host."""
    spans = {name: {"count": n, "total_s": total * 1e-9,
                    "self_s": (total - child) * 1e-9}
             for name, (n, total, child) in _totals.items()}
    counters = dict(_counters)
    for name in _device:
        counters[name] = counter(name)
    return {"spans": spans, "counters": counters}


def recent() -> List[Tuple[str, int, int, Optional[str]]]:
    """The last `RECENT` closed spans, oldest first: (name, start_ns,
    end_ns, the name of the span directly around it or None)."""
    return list(_recent)


def reset() -> None:
    """Forget the spans and counters recorded so far, and zero the device
    counters (on their devices' current streams). Called with no span open
    in this thread and outside a capture."""
    if _open():
        raise RuntimeError(f"tracing.reset inside the span {_open()[-1].name!r}")
    _totals.clear()
    _recent.clear()
    _counters.clear()
    for slots in _device.values():
        for s in slots:
            s.zero_()
