"""Platform bootstrap / system info — the reference's Platform subsystem
(Platform.cpp:39-184 initSDL + :381-400 checkFeatureSupport + system
logging). Headless equivalent: device discovery + host capability dump,
logged at startup by the CLI."""

from __future__ import annotations

import os
import platform as _platform
from typing import Dict, List

import torch
import torch.distributed as dist

from opencl_ray_tracer_tpu_torch.utils.log import log_info
from opencl_ray_tracer_tpu_torch.utils.memory import get_host_memory_usage_bytes


def cpu_features() -> List[str]:
    """Host SIMD feature detection (checkFeatureSupport role)."""
    feats = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = set(line.split(":")[1].split())
                    for name in ("sse2", "sse4_1", "sse4_2", "avx", "avx2",
                                 "avx512f", "fma"):
                        if name in flags:
                            feats.append(name.upper())
                    break
    except OSError:
        pass
    return feats


def system_info() -> Dict[str, object]:
    n_cards = torch.cuda.device_count()
    return {
        "os": f"{_platform.system()} {_platform.release()}",
        "python": _platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "gpu" if n_cards else "cpu",
        "devices": ([f"gpu:{torch.cuda.get_device_name(i)}#{i}"
                     for i in range(n_cards)] or ["cpu:host#0"]),
        "process_count": dist.get_world_size() if dist.is_initialized() else 1,
        "cpu_count": os.cpu_count(),
        "cpu_features": cpu_features(),
        "host_rss_mb": round(get_host_memory_usage_bytes() / 1e6, 1),
    }


def log_system_info() -> None:
    """The reference logs all of this at Platform::initSDL time."""
    for k, v in system_info().items():
        log_info("%s: %s", k, v)
