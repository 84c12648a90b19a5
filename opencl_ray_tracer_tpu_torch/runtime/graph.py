"""The port's `jax.jit` for the card: functions captured as CUDA graphs.

The JAX package runs a frame and a train step each as one compiled device
program (`jax.jit`; `_render_tiled_jit`, the train step of
parallel/train.py). Eagerly, the port dispatches each of their hundreds of
small launches from Python. A captured graph is the counterpart of that one
program: `capture` runs a function on a side stream (the warm-up builds the
kernel library and makes the per-device constants of `device_const`,
cuBLAS and cuSOLVER handles, optimizer state), then captures it into a
`torch.cuda.CUDAGraph`; a replay is one launch from the host.

`GraphCache` is the one holder of such graphs by key (the caller's key,
the arguments' structure and static values, the tensors' shapes and
dtypes, the device; the 8 keys used last). It captures over static copies
of the inputs, and each later call of the key copies its inputs in and
replays. Its two owners differ only in the call that captures: `jit(fn)`
captures at a key's first call; `kernels.fwd_tiled.render_tiled` runs a
key's first frame eagerly through the holder and captures at its second.
CPU tensors run the function as it is. The train step keeps a holder of its
own (`parallel.train`), whose capture saves and restores the optimizer's
state around the warm-up.

A captured function may not wait for the card or read a device value on
the host (`.item()`, `bool(tensor)`, `torch.nonzero`, a host branch on a
flag) or copy from pageable host memory (`torch.tensor(list,
device=...)`). The frame and step paths of the port
choose between the tiled and the brute kernels on the card instead, through
`cond`, the counterpart of `lax.cond`: captured, each branch is a
conditional node of the graph and a replay runs only the branch its flag
takes. A capture that meets such a call, or cannot place a conditional
node, fails, and the failure raises with CUDA's message: a captured path
never falls back to running eagerly on the card, nor to running both
branches.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from opencl_ray_tracer_tpu_torch.utils import tracing

_CONSTS: Dict[tuple, torch.Tensor] = {}


def device_const(values, device) -> torch.Tensor:
    """A float32 constant (a numpy array, or numbers) on `device`, copied
    from the host once per value and device and shared after: the frame and
    step paths make no host-to-device copy per call, so a CUDA graph can
    capture them. Read only: callers never write to it."""
    arr = np.array(values, dtype=np.float32)  # a number stays 0-d
    dev = torch.device(device)
    key = (arr.tobytes(), arr.shape, dev)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.from_numpy(arr.copy()).to(dev)
    return t


def device_scalar(x, device) -> torch.Tensor:
    """A float32 scalar on `device`: a tensor as it is (cast and moved if
    needed), a Python number through `device_const`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return device_const(x, device)


# ---------------------------------------------------------------------------
# Arguments as trees of tensors and static values
# ---------------------------------------------------------------------------

_TENSOR = "tensor"


def _flatten(x, leaves: list):
    """The structure of x (hashable), appending its tensors to `leaves`:
    tuples, lists, dicts, NamedTuples and dataclasses are walked; any other
    value is static (part of the structure, so a new value captures anew)."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _TENSOR
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        keys = tuple(x)
        return (dict, keys, tuple(_flatten(x[k], leaves) for k in keys))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x) if f.init)
        return (type(x), names, tuple(_flatten(getattr(x, n), leaves)
                                      for n in names))
    return ("static", x)


def _unflatten(spec, tensors):
    """Inverse of `_flatten`, taking the tensors from the iterator."""
    if spec == _TENSOR:
        return next(tensors)
    kind = spec[0]
    if kind == "static":
        return spec[1]
    if kind is dict:
        return {k: _unflatten(s, tensors) for k, s in zip(spec[1], spec[2])}
    if isinstance(kind, type) and dataclasses.is_dataclass(kind):
        return kind(**{n: _unflatten(s, tensors) for n, s in zip(spec[1], spec[2])})
    values = [_unflatten(s, tensors) for s in spec[1]]
    if hasattr(kind, "_fields"):  # a NamedTuple
        return kind(*values)
    return kind(values)


def _same_tree(a, b):
    """(structure, a's tensors, b's tensors) of two branch results, which
    must match as JAX requires: the same structure and static values, and
    tensors of the same shape, dtype and device."""
    la: list = []
    lb: list = []
    sa, sb = _flatten(a, la), _flatten(b, lb)
    if sa != sb:
        raise ValueError(f"cond: the branches return different structures: "
                         f"{sa} and {sb}")
    for i, (x, y) in enumerate(zip(la, lb)):
        if (x.shape, x.dtype, x.device) != (y.shape, y.dtype, y.device):
            raise ValueError(
                f"cond: the branches' tensor {i} differs: {tuple(x.shape)} "
                f"{x.dtype} on {x.device} and {tuple(y.shape)} {y.dtype} on "
                f"{y.device}")
    return sa, la, lb


# ---------------------------------------------------------------------------
# cond: the port's lax.cond
# ---------------------------------------------------------------------------

_CAPTURES: list = []  # the _Bodies of the capture under way
_WARMING = 0  # depth of captures warming up: their conds make their counters
_BODY_STREAMS: Dict[torch.device, torch.cuda.ExternalStream] = {}


def _library():
    from opencl_ray_tracer_tpu_torch.kernels._build import load_library

    return load_library()


def _check_rc(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"cond: {what} failed: "
                           f"{lib.octrt_cuda_error_string(rc).decode()} "
                           f"(cudaError {rc})")


def _body_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """The stream every branch body on `device` is captured on, made once
    (outside a capture: the warm-up's uncaptured conds make it)."""
    s = _BODY_STREAMS.get(device)
    if s is None:
        lib = _library()
        ptr = ctypes.c_void_p()
        with torch.cuda.device(device):
            _check_rc(lib, lib.octrt_body_stream(ctypes.byref(ptr)),
                      "making the body stream")
        s = _BODY_STREAMS[device] = torch.cuda.ExternalStream(ptr.value,
                                                              device=device)
    return s


class _Bodies:
    """What the conds of one capture share: the device's body stream and a
    memory pool for what the bodies allocate. PyTorch sends a capture's
    allocations to the graph's pool by the capture's id; a body is captured
    on a stream of its own with another id, so its allocations are sent to
    this pool by stream instead, from the capture's first cond until the
    capture ends. The pool lives as long as the graph (`release`)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = None
        self.depth = 0  # bodies under capture: a cond there would nest

    def open(self) -> torch.cuda.ExternalStream:
        stream = _body_stream(self.device)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            with torch.cuda.stream(stream):
                torch._C._cuda_beginAllocateCurrentStreamToPool(
                    self.device.index, self.pool)
        return stream

    def close(self):
        if self.pool is not None:
            torch._C._cuda_endAllocateToPool(self.device.index, self.pool)

    def release(self):
        if self.pool is not None:
            torch._C._cuda_releasePool(self.device.index, self.pool)


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable,
         operands: tuple = (), *, site: Optional[str] = None):
    """The port's `jax.lax.cond`: `true_fn(*operands)` where the one bool in
    `pred` is set, else `false_fn(*operands)`. Both branches return the same
    structure of tensors (tuples, lists, dicts, NamedTuples, dataclasses)
    with the same shapes and dtypes, and each is called as
    `fn(*operands, run_if=flag)`; it passes `flag` to the kernels it
    launches (`run_if=flag, want=1` in the true branch, `want=0` in the
    false one). Not differentiable itself: it runs under `no_grad`, and a
    gradient is a cond of its own (`soft_tiled._soft_tiled_core`).

    - CPU tensors: both branches run (flag None) and each output tensor is
      selected with `torch.where`.
    - CUDA tensors, no capture under way (the warm-up of `jit`, eager
      callers): both branches run with `flag` the predicate as one int32
      on the card, so the kernels of the branch not taken return at once,
      then `torch.where` selects. The warm-up thus makes whatever either
      branch makes lazily before the capture.
    - CUDA tensors under `capture`: each branch becomes an IF node of the
      graph, on the negation of `pred` and on `pred`
      (kernels/csrc/graph_cond.cu), captured with flag None; the true
      branch's outputs are copied into the false branch's, which leave the
      cond (the port's flags mark the rare case, an overflow, so the common
      branch copies nothing). A replay runs only the branch taken, and
      nothing of the other: no launch, no fill, no operand preparation. A
      capture that cannot place a node raises with CUDA's message; a cond
      inside a branch raises.

    A branch returns tensors it computes: one that shares its storage with
    an operand is copied first, so that the true branch's copy never writes
    into an operand.

    `site` names the cond for the device counter `cond.<site>.brute`
    (`utils.tracing`): each replay of a graph that holds the cond adds 1
    there where `pred` is set, in the kernel that sets the branches, with
    no node of its own. The counter's slot is made by the warm-up of
    `capture` (a fill captured with the graph would clear it at every
    replay); an uncaptured cond counts nothing."""
    if not (isinstance(pred, torch.Tensor) and pred.dtype == torch.bool
            and pred.numel() == 1):
        raise TypeError(f"cond: pred must be one bool tensor, got {pred!r}")
    pred = pred.reshape(())
    with torch.no_grad():
        if pred.is_cuda and torch.cuda.is_current_stream_capturing():
            return _cond_nodes(pred, true_fn, false_fn, operands, site)
        flag = None
        if pred.is_cuda:
            _body_stream(pred.device)
            if site is not None and _WARMING:
                tracing.device_counter(_counter_name(site), pred.device)
            flag = pred.to(torch.int32)
        a = true_fn(*operands, run_if=flag)
        b = false_fn(*operands, run_if=flag)
        spec, la, lb = _same_tree(a, b)
        return _unflatten(spec, iter([torch.where(pred, x, y)
                                      for x, y in zip(la, lb)]))


def _counter_name(site: str) -> str:
    return f"cond.{site}.brute"


def _cond_nodes(pred, true_fn, false_fn, operands, site):
    """`cond` under a capture: two IF nodes (see `cond`)."""
    if not _CAPTURES:
        raise RuntimeError("cond: a conditional node needs a capture begun by "
                           "runtime.graph.capture")
    bodies = _CAPTURES[-1]
    if bodies.depth:
        raise RuntimeError("cond: a cond inside a branch of a captured cond is "
                           "not supported")
    if pred.device != bodies.device:
        raise ValueError(f"cond: pred on {pred.device}, the capture on "
                         f"{bodies.device}")
    slot = None
    if site is not None:
        slot = tracing.device_counter(_counter_name(site), pred.device, make=False)
        if slot is None:
            raise RuntimeError(f"cond: the site {site!r} has no counter on "
                               f"{pred.device}: capture through "
                               f"runtime.graph.capture with a warm-up")
    lib = _library()
    body = bodies.open()
    main = ctypes.c_void_p(torch.cuda.current_stream(pred.device).cuda_stream)
    body_ptr = ctypes.c_void_p(body.cuda_stream)
    handles = (ctypes.c_ulonglong * 2)()
    _check_rc(lib, lib.octrt_cond_handles(
        ctypes.c_void_p(pred.data_ptr()), handles, main,
        ctypes.c_void_p(None if slot is None else slot.data_ptr())),
        "placing its handles")
    operand_leaves: list = []
    _flatten(operands, operand_leaves)
    storages = {t.untyped_storage().data_ptr() for t in operand_leaves}
    outs = []
    for handle, fn in ((handles[1], false_fn), (handles[0], true_fn)):
        _check_rc(lib, lib.octrt_cond_begin_body(handle, main, body_ptr),
                  "placing a conditional node")
        bodies.depth += 1
        try:
            with torch.cuda.stream(body):
                out = fn(*operands, run_if=None)
                if not outs:
                    leaves: list = []
                    spec = _flatten(out, leaves)
                    out = _unflatten(spec, iter([
                        t.clone() if t.untyped_storage().data_ptr() in storages
                        else t for t in leaves]))
                else:
                    _, la, lb = _same_tree(outs[0], out)
                    for x, y in zip(la, lb):
                        x.copy_(y)
        finally:
            bodies.depth -= 1
            rc = lib.octrt_cond_end_body(body_ptr)
        _check_rc(lib, rc, "capturing a branch")
        outs.append(out)
    return outs[0]


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------

def capture(fn: Callable[[], Any], *, warmup: int = 2,
            name: str = "") -> Tuple[torch.cuda.CUDAGraph, Any]:
    """(graph, outputs): `fn()` run `warmup` times on a side stream, then
    captured on the current device. The outputs are the captured call's
    tensors; each `graph.replay()` writes them anew. The warm-up runs both
    branches of every `cond` (so whatever either branch makes lazily, the
    kernel library, `device_const`s, cuBLAS and cuSOLVER handles, exists
    before the capture); the capture places each `cond` as conditional
    nodes. A capture that fails raises a RuntimeError that carries CUDA's
    message. Its seconds, warm-up and capture, add to the counter
    `graph.capture_s` (`utils.tracing`)."""
    t0 = time.perf_counter()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    global _WARMING
    with torch.cuda.stream(side):
        _WARMING += 1
        try:
            for _ in range(warmup):
                fn()
        finally:
            _WARMING -= 1
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    bodies = _Bodies(torch.device("cuda", torch.cuda.current_device()))
    _CAPTURES.append(bodies)
    try:
        with torch.cuda.graph(graph):
            out = fn()
    except RuntimeError as e:
        raise RuntimeError(f"capturing {name or fn!r} into a CUDA graph "
                           f"failed: {e}") from e
    finally:
        _CAPTURES.pop()
        bodies.close()
        # the bodies' memory lives as long as the graph (and is left to the
        # process's end where the graph is)
        weakref.finalize(graph, bodies.release).atexit = False
    tracing.count("graph.capture_s", time.perf_counter() - t0)
    return graph, out


def replay(graph: torch.cuda.CUDAGraph, name: str) -> None:
    """`graph.replay()` inside the span `graph.replay`, counted under
    `graph.replays.<name>` (`utils.tracing`)."""
    tracing.count("graph.replays." + name)
    with tracing.span("graph.replay"):
        graph.replay()


@dataclasses.dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    inputs: list        # the static input buffers, in leaf order
    outputs: Any        # the static outputs


def _card(leaves) -> Optional[torch.device]:
    """The one CUDA device a call's tensors lie on; None where none lies on
    CUDA (the CPU, as asked). Raises where they lie on several devices."""
    devices = {t.device for t in leaves}
    if not any(d.type == "cuda" for d in devices):
        return None
    if len(devices) != 1:
        raise ValueError(f"graph: the inputs lie on {sorted(map(str, devices))}; "
                         "a graph runs on one device")
    return devices.pop()


class GraphCache:
    """The port's one holder of captured CUDA graphs, by key: `jit`'s and
    the eager hard frame's (`kernels.fwd_tiled.render_tiled`).

    `cache(key, fn, *args)` -> (outputs, replayed). A call's key is the
    caller's `key`, the arguments' structure with their static values,
    their tensors' shapes and dtypes, and the device; `fn` closes over
    nothing that `key` does not name. The call at which a key is captured
    is the only difference between the owners: `capture_at` 1 (`jit`)
    captures at a key's first call; 2 (`render_tiled`, whose first frame of
    a key runs eagerly) runs `fn(*args)` as it is at the first call and
    returns its output, and captures at the second. The capturing call
    warms `fn` up and captures it over static copies of the tensors
    (`capture`); it and every later call copy the tensors into those copies
    and replay, and return the graph's static outputs, which the next
    replay of the key overwrites: callers `clone()` what they keep.
    `replayed` says which of the two a call returned. Tensors on no CUDA
    device run `fn(*args)` and are never held. At most `size` keys are
    held, seen once or captured alike; the least recently used goes first,
    with its graph."""

    size = 8

    def __init__(self, name: str, capture_at: int = 2):
        self.name = name
        self.capture_at = capture_at
        self.held: "collections.OrderedDict[tuple, Optional[_Captured]]" = \
            collections.OrderedDict()

    def __call__(self, key, fn: Callable, *args):
        leaves: list = []
        spec = _flatten(args, leaves)
        device = _card(leaves)
        if device is None:
            return fn(*args), False
        key = (key, spec, tuple((tuple(t.shape), t.dtype) for t in leaves), device)
        if key in self.held:
            self.held.move_to_end(key)
            entry = self.held[key]
        else:
            entry = self.held[key] = None
            while len(self.held) > self.size:
                self.held.popitem(last=False)
            if self.capture_at > 1:
                return fn(*args), False
        with torch.cuda.device(device):
            if entry is None:
                with torch.no_grad():
                    bufs = [t.detach().clone() for t in leaves]
                static = _unflatten(spec, iter(bufs))
                graph, out = capture(lambda: fn(*static), name=self.name)
                entry = self.held[key] = _Captured(graph, bufs, out)
            with torch.no_grad():
                for buf, t in zip(entry.inputs, leaves):
                    buf.copy_(t)
            replay(entry.graph, self.name)
        return entry.outputs, True


def jit(fn: Callable, *, static: Iterable[str] = ()) -> Callable:
    """`fn` compiled for the card, the port's `jax.jit`: a call through a
    `GraphCache` that captures at a key's first call.

    On CUDA tensors the first call warms `fn` up on a side stream and
    captures it into a CUDA graph over static copies of its tensor inputs
    (tensors anywhere in tuples, lists, dicts, NamedTuples and dataclasses
    such as Camera, PackedScene or TileBins); each later call copies its
    inputs into those buffers and replays the graph. The keyword arguments
    named in `static` (JAX's `static_argnames`) and every non-tensor value in
    the arguments are part of what was captured: a new value, or a new shape
    or dtype of a tensor, captures again, and the 8 keys used last are held
    (`GraphCache.size`). The result is the graph's static output, which the
    next replay overwrites: callers `clone()` what they keep. Inputs are
    copied as values: no autograd history crosses the call. The holder is
    the callable's `graphs`.

    With CPU tensors `fn` runs as it is: the caller asked for the CPU. A
    capture that fails raises with CUDA's message and never runs `fn`
    eagerly on the card instead."""
    static = tuple(static)
    # a functools.partial is named by its function
    graphs = GraphCache(getattr(fn, "__name__", None) or getattr(
        getattr(fn, "func", None), "__name__", ""), capture_at=1)

    def compiled(*args, **kwargs):
        st = tuple((k, kwargs.pop(k)) for k in static if k in kwargs)
        return graphs(st, lambda a, kw: fn(*a, **kw, **dict(st)), args, kwargs)[0]

    compiled.__doc__ = getattr(fn, "__doc__", None)
    compiled.graphs = graphs
    return compiled
