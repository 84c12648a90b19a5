"""The harness's own spans around its calls into the program's layers.

A span is a `torch.profiler.record_function` range named "rtbench.<layer>.
<what>", so that a profiler trace holds it on the same clock as the device's
operations. Spans are recorded only while `on` is set (the traced stretch
of a `--trace 1` run); elsewhere `span` costs one attribute test."""

from __future__ import annotations

import contextlib

PREFIX = "rtbench."
_NULL = contextlib.nullcontext()


class Spans:
    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        if not self.on:
            return _NULL
        import torch

        return torch.profiler.record_function(PREFIX + name)
