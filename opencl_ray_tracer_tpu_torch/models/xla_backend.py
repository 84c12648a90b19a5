"""The whole-frame backend ("xla"): the pipeline as plain PyTorch ops on
the scene's device.

Ray generation, intersection, nearest hit and shading are the tensor
expressions of ops/, run over every pixel and every primitive with no
binning and no hand-written kernel. It is the fallback for what the tiled
kernel does not cover and the apples-to-apples baseline that kernel must
beat. Memory is bounded by walking the frame in blocks of `row_chunk` rows
(peak intermediate size row_chunk * W * primitives, not H * W *
primitives), as the JAX package maps over row chunks. `render_xla_jit` is
the same frame compiled as a CUDA graph, as JAX's is one jitted program.
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
from opencl_ray_tracer_tpu_torch.runtime.graph import jit


def trace_pixels(scene, o, d, *, shading: str, shadows: bool):
    """Trace arbitrary ray bundles: o/d (..., 3) -> RGBA float (..., 4)."""
    hit = nearest_hit(o, d, scene)
    if shading == "legacy":
        return shade_legacy(hit)
    if shading == "lambert":
        return shade_lambert(hit, d, scene, shadows=shadows)
    if shading == "phong":
        return shade_phong(hit, d, scene, shadows=shadows)
    raise ValueError(f"unknown shading mode {shading!r}")


@torch.no_grad()
def _xla_frame(scene, camera: Camera, height: int, width: int,
               shading: str = "legacy", shadows: bool = False,
               row_chunk: int = 32, as_int: bool = True) -> torch.Tensor:
    """The whole frame in plain ops: (H, W, 4) int32 (truncated) when
    `as_int`, else float32. A height that is a multiple of `row_chunk` (and
    larger) is traced a block of rows at a time; any other frame at once."""
    o, d = camera.rays(height, width)
    trace = lambda oc, dc: trace_pixels(  # noqa: E731
        scene, oc, dc, shading=shading, shadows=shadows)
    if height > row_chunk and height % row_chunk == 0:
        rgba = torch.cat([trace(o[r:r + row_chunk], d[r:r + row_chunk])
                          for r in range(0, height, row_chunk)])
    else:
        rgba = trace(o, d)
    return to_int_framebuffer(rgba) if as_int else rgba


def render_xla(scene, camera: Camera, config: RenderConfig,
               row_chunk: int = 32) -> torch.Tensor:
    """Render a frame on the scene's device: (H, W, 4) int32 for
    framebuffer_dtype "int" (truncated), else float32, `row_chunk` rows at
    a time (see `_xla_frame`)."""
    return _xla_frame(scene, camera, config.height, config.width,
                      config.shading, config.shadows, row_chunk,
                      config.framebuffer_dtype == "int")


# render_xla_jit(scene, camera, height=..., width=..., shading="legacy",
# shadows=False, row_chunk=32, as_int=True): the JAX package's jitted frame,
# through runtime.graph.jit. On the card the first call for a frame size,
# mode and input shapes captures a CUDA graph, and every call replays it and
# returns the graph's static output (clone what you keep); on the CPU it
# runs `_xla_frame` eagerly.
render_xla_jit = jit(_xla_frame, static=("height", "width", "shading", "shadows",
                                         "row_chunk", "as_int"))
