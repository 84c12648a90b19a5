"""Oracle tracer — the reference's "slow twin" backend, in plain torch.

The reference keeps a deliberately simple serial CPU tracer
(states/MainState.cpp:936-972) as the correctness oracle for its OpenCL
kernel. This module is that component for the port: the clearest statement
of the semantics (brute force over every primitive, no culling), row-chunked
only so full frames fit in memory.

`render_reference` is the backend "reference": like the JAX package's, it
runs on the host CPU whatever device the scene lies on, and returns a CPU
tensor, so that the reference's CPU-vs-accelerator comparison (`cli
compare`, the app's backend toggle) times the CPU. `_render_oracle` is the
same computation on the device the scene's tensors lie on: the oracle that
holds a kernel's frame on the card.
"""

from __future__ import annotations

import torch

from opencl_ray_tracer_tpu_torch.camera import Camera
from opencl_ray_tracer_tpu_torch.config import RenderConfig
from opencl_ray_tracer_tpu_torch.models.xla_backend import trace_pixels
from opencl_ray_tracer_tpu_torch.ops import to_int_framebuffer
from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays, scene_to_arrays


@torch.no_grad()
def _render_oracle(scene, camera: Camera, config: RenderConfig,
                   row_chunk: int = 64) -> torch.Tensor:
    """The oracle on the scene's device. Returns int32 (H, W, 4) in "int"
    mode (bit-exact reference semantics), else float32 (H, W, 4)."""
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


def render_reference(scene, camera: Camera, config: RenderConfig) -> torch.Tensor:
    """Render on the oracle on the host CPU (the scene and the camera are
    copied there) and return the CPU framebuffer, as `_render_oracle`."""
    cpu = torch.device("cpu")
    return _render_oracle(scene_from_arrays(scene_to_arrays(scene), cpu),
                          camera.to(cpu), config)
