"""Backend discovery & dispatch — the OpenCL host-runtime role, on torch.

The reference enumerates platforms/devices, prefers a GPU and falls back to
device 0 (states/MainState.cpp:1181-1271). Here device discovery is
torch.cuda, and the backend names are the JAX package's, so one config file
drives both packages:

  reference -> ref/tracer.py    (the brute-force oracle, on the host CPU)
  xla       -> models/xla_backend.py (the whole frame in plain torch ops,
               on the scene's device)
  pallas    -> the tiled kernel (CUDA kernel on a CUDA scene, its plain
               twin on a CPU scene)
"""

from __future__ import annotations

import enum
from typing import List, Union

import torch

from opencl_ray_tracer_tpu_torch.utils.log import log_info


class Backend(enum.Enum):
    """Renderer backends (the F1 mode toggle, MainState.h:48-52)."""

    REFERENCE = "reference"  # brute-force oracle on the host CPU
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


def log_devices() -> None:
    for line in describe_devices():
        log_info("device: %s", line)


def card_or(device=None, what: str = "this") -> torch.device:
    """`device`, or the card (cuda:0) when it is None. Raises when a card is
    needed and none is visible: `what` runs on the card unless the caller
    asks for the CPU (no silent fallback)."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is visible: {what} runs on the card "
                           f"(ask for device 'cpu' to run it on the CPU)")
    return device


def default_device() -> torch.device:
    """Prefer the card, else the CPU (MainState.cpp:1242-1271 policy)."""
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


def on_accelerator() -> bool:
    return default_device().type != "cpu"


def available_backends() -> List[Backend]:
    return list(Backend)


def default_backend() -> Backend:
    """The tiled kernel (pallas) on a card; the whole-frame plain path
    (xla) on the CPU, where the kernel would run as its plain twin."""
    return Backend.PALLAS if on_accelerator() else Backend.XLA


def resolve_backend(name: Union[Backend, str, None]) -> Backend:
    """A backend name -> Backend; None is the tiled kernel path, which runs
    where the scene lies (the CUDA kernel on the card, its twin on CPU)."""
    if name is None:
        return Backend.PALLAS
    if isinstance(name, Backend):
        return name
    return Backend(name)
