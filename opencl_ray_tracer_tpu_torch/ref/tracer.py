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
from opencl_ray_tracer_tpu_torch.models.xla_backend import trace_pixels
from opencl_ray_tracer_tpu_torch.ops import to_int_framebuffer


@torch.no_grad()
def render_reference(scene, camera: Camera, config: RenderConfig,
                     row_chunk: int = 64) -> torch.Tensor:
    """Render on the oracle. Returns int32 (H, W, 4) in "int" mode
    (bit-exact reference semantics), else float32 (H, W, 4)."""
    o, d = camera.rays(config.height, config.width)   # (H, W, 3) each
    rgba = torch.cat(
        [
            trace_pixels(scene, o[r : r + row_chunk], d[r : r + row_chunk],
                         shading=config.shading, shadows=config.shadows)
            for r in range(0, config.height, row_chunk)
        ],
        dim=0,
    )
    if config.framebuffer_dtype == "int":
        return to_int_framebuffer(rgba)
    return rgba
