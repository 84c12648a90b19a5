"""The port's `jax.jit` for the card: a function captured once as a CUDA graph.

The JAX package runs a frame and a train step each as one compiled device
program (`jax.jit`; `_render_tiled_jit`, the train step of
parallel/train.py). Eagerly, the port dispatches each of their hundreds of
small launches from Python. `jit(fn)` is the counterpart of that one
program: the first call with CUDA tensors runs `fn` on a side stream (the
warm-up builds the kernel library and makes the per-device constants of
`device_const`, cuBLAS and cuSOLVER handles, optimizer state), then
captures it into a `torch.cuda.CUDAGraph` over static copies of the
inputs. Every later call copies its inputs into those buffers and replays
the graph: one launch from the host.

What a captured function may not do is what `jit` forbids too: wait for the
card or read a device value on the host (`.item()`, `bool(tensor)`,
`torch.nonzero`, a host branch on a flag) or copy from pageable host memory
(`torch.tensor(list, device=...)`). The frame and step paths of the port
choose between the tiled and the brute kernels on the card instead (the
kernels' `run_if`, the counterpart of `lax.cond`). A capture that meets such
a call fails, and the failure raises with CUDA's message: a captured path
never falls back to running eagerly on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Tuple

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------

def capture(fn: Callable[[], Any], *, warmup: int = 2,
            name: str = "") -> Tuple[torch.cuda.CUDAGraph, Any]:
    """(graph, outputs): `fn()` run `warmup` times on a side stream, then
    captured on the current device. The outputs are the captured call's
    tensors; each `graph.replay()` writes them anew. A capture that fails
    raises a RuntimeError that carries CUDA's message."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn()
    except RuntimeError as e:
        raise RuntimeError(f"capturing {name or fn!r} into a CUDA graph "
                           f"failed: {e}") from e
    return graph, out


@dataclasses.dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    inputs: list        # the static input buffers, in leaf order
    outputs: Any        # the static outputs


class Compiled:
    """A function run as a CUDA graph on CUDA tensors (see `jit`)."""

    def __init__(self, fn: Callable, static: Iterable[str] = ()):
        self.fn = fn
        self.static = tuple(static)
        self.graphs: Dict[tuple, _Captured] = {}
        self.__doc__ = getattr(fn, "__doc__", None)

    def __call__(self, *args, **kwargs):
        st = {k: kwargs.pop(k) for k in self.static if k in kwargs}
        leaves: list = []
        spec = _flatten((args, kwargs), leaves)
        if not any(t.is_cuda for t in leaves):
            return self.fn(*args, **kwargs, **st)  # the CPU, as asked
        devices = {t.device for t in leaves}
        if len(devices) != 1:
            raise ValueError(f"jit: the inputs lie on {sorted(map(str, devices))}; "
                             "a graph runs on one device")
        key = (spec, tuple(sorted(st.items())),
               tuple((tuple(t.shape), t.dtype) for t in leaves), devices.pop())
        entry = self.graphs.get(key)
        with torch.cuda.device(leaves[0].device):
            if entry is None:
                entry = self.graphs[key] = self._capture(spec, st, leaves)
            else:
                with torch.no_grad():
                    for buf, t in zip(entry.inputs, leaves):
                        buf.copy_(t)
            entry.graph.replay()
        return entry.outputs

    def _capture(self, spec, st, leaves) -> _Captured:
        with torch.no_grad():
            bufs = [t.detach().clone() for t in leaves]
        args, kwargs = _unflatten(spec, iter(bufs))
        graph, out = capture(lambda: self.fn(*args, **kwargs, **st),
                             name=getattr(self.fn, "__name__", ""))
        return _Captured(graph, bufs, out)


def jit(fn: Callable, *, static: Iterable[str] = ()) -> Compiled:
    """`fn` compiled for the card, the port's `jax.jit`.

    On CUDA tensors the first call warms `fn` up on a side stream and
    captures it into a CUDA graph over static copies of its tensor inputs
    (tensors anywhere in tuples, lists, dicts, NamedTuples and dataclasses
    such as Camera, PackedScene or TileBins); each later call copies its
    inputs into those buffers and replays the graph. The keyword arguments
    named in `static` (JAX's `static_argnames`) and every non-tensor value in
    the arguments are part of what was captured: a new value, or a new shape
    or dtype of a tensor, captures again. The result is the graph's static
    output, which the next replay overwrites: callers `clone()` what they
    keep. Inputs are copied as values: no autograd history crosses the call.

    With CPU tensors `fn` runs as it is: the caller asked for the CPU. A
    capture that fails raises with CUDA's message and never runs `fn`
    eagerly on the card instead."""
    return Compiled(fn, static)
