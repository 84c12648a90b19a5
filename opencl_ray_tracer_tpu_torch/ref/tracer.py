"""Oracle tracer — the reference's "slow twin" backend, in plain torch.

The reference keeps a deliberately simple serial CPU tracer
(states/MainState.cpp:936-972) as the correctness oracle for its OpenCL
kernel. This module is that component for the port: the clearest statement
of the semantics (brute force over every primitive, no culling), row-chunked
only so full frames fit in memory. It runs on whatever device the scene's
tensors lie on.
"""

from __future__ import annotations

import torch

from opencl_ray_tracer_tpu_torch.camera import Camera
from opencl_ray_tracer_tpu_torch.config import RenderConfig
from opencl_ray_tracer_tpu_torch.ops import (
    nearest_hit,
    shade_lambert,
    shade_legacy,
    shade_phong,
    to_int_framebuffer,
)


def _trace_rows(scene, o, d, *, shading: str, shadows: bool):
    """Trace a block of rays: o, d (..., 3) -> RGBA float (..., 4)."""
    hit = nearest_hit(o, d, scene)
    if shading == "legacy":
        return shade_legacy(hit)
    if shading == "lambert":
        return shade_lambert(hit, d, scene, shadows=shadows)
    if shading == "phong":
        return shade_phong(hit, d, scene, shadows=shadows)
    raise ValueError(f"unknown shading mode {shading!r}")


@torch.no_grad()
def render_reference(scene, camera: Camera, config: RenderConfig,
                     row_chunk: int = 64) -> torch.Tensor:
    """Render on the oracle. Returns int32 (H, W, 4) in "int" mode
    (bit-exact reference semantics), else float32 (H, W, 4)."""
    o, d = camera.rays(config.height, config.width)   # (H, W, 3) each
    rgba = torch.cat(
        [
            _trace_rows(scene, o[r : r + row_chunk], d[r : r + row_chunk],
                        shading=config.shading, shadows=config.shadows)
            for r in range(0, config.height, row_chunk)
        ],
        dim=0,
    )
    if config.framebuffer_dtype == "int":
        return to_int_framebuffer(rgba)
    return rgba
