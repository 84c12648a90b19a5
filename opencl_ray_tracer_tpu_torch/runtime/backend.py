"""Backend discovery & dispatch — the OpenCL host-runtime role, on torch.

The reference enumerates platforms/devices, prefers a GPU and falls back to
device 0 (states/MainState.cpp:1181-1271). Here device discovery is
torch.cuda, and the backend names are the JAX package's, so one config file
drives both packages:

  reference -> ref/tracer.py    (the brute-force oracle, any device)
  xla       -> models/xla_backend.py (the whole frame in plain torch ops,
               on the scene's device)
  pallas    -> the tiled kernel (CUDA kernel on a CUDA scene, its plain
               twin on a CPU scene)
"""

from __future__ import annotations

import enum
from typing import List, Union

import torch


class Backend(enum.Enum):
    """Renderer backends (the F1 mode toggle, MainState.h:48-52)."""

    REFERENCE = "reference"  # brute-force oracle
    XLA = "xla"              # whole frame in plain torch ops
    PALLAS = "pallas"        # tiled kernel: CUDA on the card, twin on CPU


def describe_devices() -> List[str]:
    """Device capability dump, the analogue of MainState.cpp:1204-1260."""
    lines = [f"torch={torch.__version__} cuda={torch.version.cuda}"]
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        lines.append(
            f"id={i} platform=gpu kind={p.name} sms={p.multi_processor_count} "
            f"memory={p.total_memory / 2**30:.1f}GiB "
            f"capability={p.major}.{p.minor}"
        )
    if not torch.cuda.is_available():
        lines.append("no CUDA device is visible")
    return lines


def resolve_backend(name: Union[Backend, str, None]) -> Backend:
    """A backend name -> Backend; None is the tiled kernel path, which runs
    where the scene lies (the CUDA kernel on the card, its twin on CPU)."""
    if name is None:
        return Backend.PALLAS
    if isinstance(name, Backend):
        return name
    return Backend(name)
