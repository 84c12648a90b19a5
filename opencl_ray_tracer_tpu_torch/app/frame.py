"""Frame loop — the reference's main loop (main.cpp:24-88), headless.

Event pump -> StateManager.eventHandler/update -> render, with DeltaTime and
an optional frame cap (main.cpp:77-80 caps at 60 FPS). Two drive modes:

  run_interactive(): reads single keys from the TTY (the SDL window role)
  run_scripted():    feeds a scripted key sequence — used by tests and CI
"""

from __future__ import annotations

import sys
import time
from typing import Iterable, List, Optional

from opencl_ray_tracer_tpu_torch.app.state import StateManager
from opencl_ray_tracer_tpu_torch.utils import DeltaTime, log_info


def run_scripted(
    manager: StateManager,
    events: Iterable[str],
    settle_frames: int = 2,
) -> List[str]:
    """Drive the app with a scripted event sequence; returns status lines."""
    dt = DeltaTime()
    lines: List[str] = []
    for ev in events:
        if not manager.event_handler(ev):
            break
        for _ in range(settle_frames):
            manager.update(dt.update())
        lines.extend(manager.render())
    return lines


def run_interactive(
    manager: StateManager,
    fps_cap: float = 60.0,
    max_frames: Optional[int] = None,
) -> None:
    """TTY-interactive loop: one key per line (press Enter), q to quit."""
    dt = DeltaTime()
    frame_budget = 1.0 / fps_cap
    frames = 0
    log_info("interactive shell: keys m/s/r/p/q (+Enter)")
    for line in manager.render():
        print(line)
    while max_frames is None or frames < max_frames:
        t0 = time.perf_counter()
        key = sys.stdin.readline()
        if not key:
            break
        key = key.strip() or "SPACE"
        if not manager.event_handler(key):
            break
        manager.update(dt.update())
        for line in manager.render():
            print(line)
        frames += 1
        elapsed = time.perf_counter() - t0
        if elapsed < frame_budget:
            time.sleep(frame_budget - elapsed)
