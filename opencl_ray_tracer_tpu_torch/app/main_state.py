"""The benchmark-harness app state — the reference's MainState
(states/MainState.{h,cpp}), headless.

The reference app IS its benchmark harness: F1 toggles CPU<->OpenCL, F2
cycles scenes 1-3, SPACE re-runs the trace, and the wall time is shown in
the UI (MainState.cpp:135-239). Same controls here:

  F1 / 'm'    cycle backend (reference -> xla -> pallas); "reference" is
              the oracle on the host CPU, the other two run on the card
  F2 / 's'    cycle scene 1 -> 2 -> 3
  SPACE / 'r' re-run the trace
  'p'         dump the current framebuffer to PNG (the encodePNG role,
              MainState.cpp:410-417 — wired up here, not commented out)
  'd'         display the framebuffer in the terminal (24-bit ANSI
              half-blocks — the SDL window blit's headless stand-in)
  'q' / ESC   quit

Timing uses the PerformanceCounter (utils/timer.py) and is reported in
MICROSECONDS like the reference UI (MainState.cpp:894-903). It covers what
the reference's OpenCL time covers (executeRayTracerOpenCL,
MainState.cpp:641-934): the frame, the fence on the card's work, and the
frame's copy to the host (the reference's map of its output buffer), into
one pinned host buffer kept across traces, which the PNG dump and the
display read.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from opencl_ray_tracer_tpu_torch.app.controller import Button
from opencl_ray_tracer_tpu_torch.app.input import InputManager
from opencl_ray_tracer_tpu_torch.app.state import State, StateManager
from opencl_ray_tracer_tpu_torch.camera import legacy_ortho_camera
from opencl_ray_tracer_tpu_torch.config import RenderConfig
from opencl_ray_tracer_tpu_torch.models import render
from opencl_ray_tracer_tpu_torch.runtime import card_or
from opencl_ray_tracer_tpu_torch.scene import create_scene
from opencl_ray_tracer_tpu_torch.utils import (
    PerformanceCounter, log_info, show, tracing, write_png,
)
from opencl_ray_tracer_tpu_torch.utils.timer import fence

BACKEND_CYCLE = ["reference", "xla", "pallas"]


class MainState(State):
    state_name = "Main State"

    def __init__(
        self,
        manager: StateManager,
        inputs: InputManager,
        config: Optional[RenderConfig] = None,
        png_dir: str = ".",
        scene_seed: int = 0,
        display: bool = False,
        device=None,
    ):
        super().__init__(manager)
        self.device = card_or(device, "the app")
        self.inputs = inputs
        self.config = config or RenderConfig()
        self.png_dir = png_dir
        self.scene_seed = scene_seed
        # Always-on presentation: re-blit the terminal framebuffer whenever
        # a trace produced a new image — the per-frame Texture->window blit
        # of the reference (MainState.cpp:241-254, main.cpp:55-81), with
        # redraws coalesced to framebuffer changes so a TTY log stays sane.
        self.display = display
        self._fb_dirty = False

        self.backend_idx = len(BACKEND_CYCLE) - 1  # start on the accelerator
        self.current_scene = 1
        self.scene = create_scene(1, seed=scene_seed, device=self.device)
        self.camera = legacy_ortho_camera(device=self.device)
        self.framebuffer = None       # the frame on its device
        # its copy in host memory, one buffer that the next trace overwrites
        self.host_framebuffer: Optional[torch.Tensor] = None
        self.time_taken_us: Optional[float] = None
        self.timer = PerformanceCounter()
        self.start = True           # run once at startup, like the reference
        self.scene_change = False

    # -- controls (MainState.cpp:137-177) -----------------------------------
    def event_handler(self, event) -> bool:
        if event in ("q", "ESC"):
            return False
        self.inputs.feed_key_tap(event)
        return True

    @property
    def backend(self) -> str:
        return BACKEND_CYCLE[self.backend_idx]

    def update(self, dt: float) -> None:
        self.inputs.update()
        # Gamepad bindings mirror the keyboard's (any attached pad): X =
        # mode toggle, Y = scene cycle, A = re-run — the reference's
        # InputManager exposes pads to every state the same way.
        pads = range(self.inputs.get_num_controllers())
        pad_x = any(self.inputs.was_controller_button_pressed(i, Button.X)
                    for i in pads)
        pad_y = any(self.inputs.was_controller_button_pressed(i, Button.Y)
                    for i in pads)
        pad_a = any(self.inputs.was_controller_button_pressed(i, Button.A)
                    for i in pads)
        if (
            self.inputs.was_key_pressed("F1")
            or self.inputs.was_key_pressed("m")
            or pad_x
        ):
            self.backend_idx = (self.backend_idx + 1) % len(BACKEND_CYCLE)
            log_info("Mode: %s", self.backend)
            self.start = True
        if (
            self.inputs.was_key_pressed("F2")
            or self.inputs.was_key_pressed("s")
            or pad_y
        ):
            self.current_scene = self.current_scene % 3 + 1
            self.scene_change = True
            self.start = True
        if (
            self.inputs.was_key_pressed("SPACE")
            or self.inputs.was_key_pressed("r")
            or pad_a
        ):
            self.start = True
        if self.inputs.was_key_pressed("d") and self.host_framebuffer is not None:
            show(self.host_framebuffer)
        if self.inputs.was_key_pressed("p") and self.host_framebuffer is not None:
            path = os.path.join(
                self.png_dir,
                f"scene{self.current_scene}_{self.backend}.png",
            )
            write_png(path, self.host_framebuffer)
            log_info("wrote %s", path)

        if self.start:
            if self.scene_change:
                self.scene = create_scene(self.current_scene, seed=self.scene_seed,
                                          device=self.device)
                self.scene_change = False
            self.run_trace()
            self.start = False

        if self.display and self._fb_dirty and self.host_framebuffer is not None:
            show(self.host_framebuffer)
            self._fb_dirty = False

    # -- the trace (MainState.cpp:180-229 dispatch) --------------------------
    def run_trace(self) -> None:
        self.timer.start_counter()
        fb = render(self.scene, self.camera, self.config, backend=self.backend)
        fence(fb)
        self._read_back(fb)
        self.time_taken_us = self.timer.stop_counter()
        self.framebuffer = fb
        self._fb_dirty = True
        log_info(
            "scene %d on %s (%s): %.0f us",
            self.current_scene,
            self.backend,
            fb.device,
            self.time_taken_us,
        )

    def _read_back(self, fb: torch.Tensor) -> None:
        """Copy `fb` into `host_framebuffer`, made (pinned where `fb` lies on
        a card) at the first trace and again when the frame's shape or dtype
        changes; the span `app.readback`, counters `app.readbacks` and
        `app.readback_bytes`. A CPU frame is copied on the host."""
        with tracing.span("app.readback"):
            buf = self.host_framebuffer
            if buf is None or buf.shape != fb.shape or buf.dtype != fb.dtype:
                buf = torch.empty(fb.shape, dtype=fb.dtype,
                                  pin_memory=fb.device.type == "cuda")
                self.host_framebuffer = buf
            buf.copy_(fb)
        tracing.count("app.readbacks")
        tracing.count("app.readback_bytes", buf.numel() * buf.element_size())

    def render(self) -> str:
        t = f"{self.time_taken_us:.0f} us" if self.time_taken_us else "N/A"
        return (
            f"Mode: {self.backend} (F1/m to switch) | "
            f"Scene {self.current_scene} (F2/s to switch) | "
            f"Time: {t} | SPACE/r re-run, p=PNG, q=quit"
        )
