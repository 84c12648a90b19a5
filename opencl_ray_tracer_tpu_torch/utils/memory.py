"""Memory introspection — the reference's MemoryCounter
(misc/MemoryCounter.cpp:7-12, Win32 pagefile usage; famously dead code).
Here it is alive and device-aware: host RSS + per-card memory stats."""

from __future__ import annotations

import os
from typing import Dict

import torch


def get_host_memory_usage_bytes() -> int:
    """Host process RSS (the getMemoryUsage role)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, ValueError, IndexError):
        return 0
    return pages * os.sysconf("SC_PAGE_SIZE")


def get_device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per visible card: the caching allocator's bytes (`bytes_in_use`,
    `peak_bytes_in_use`, `bytes_reserved`, from torch.cuda.memory_stats)
    and the card's own (`bytes_free`, `bytes_limit`, from
    torch.cuda.mem_get_info). Empty without a card."""
    out: Dict[str, Dict[str, int]] = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "bytes_free": int(free),
            "bytes_limit": int(total),
        }
    return out


def format_memory_report() -> str:
    lines = [f"host rss: {get_host_memory_usage_bytes() / 1e6:.1f} MB"]
    for dev, stats in get_device_memory_stats().items():
        used = stats.get("bytes_in_use", 0)
        limit = stats.get("bytes_limit", 0)
        lines.append(
            f"{dev}: {used / 1e6:.1f} MB in use"
            + (f" / {limit / 1e6:.1f} MB" if limit else "")
        )
    return "\n".join(lines)
