"""The whole-frame backend ("xla"): the pipeline as plain PyTorch ops on
the scene's device.

Ray generation, intersection, nearest hit and shading are the tensor
expressions of ops/, run over every pixel and every primitive with no
binning and no hand-written kernel. It is the fallback for what the tiled
kernel does not cover and the apples-to-apples baseline that kernel must
beat. Memory is bounded by walking the frame in blocks of `row_chunk` rows
(peak intermediate size row_chunk * W * primitives, not H * W *
primitives), as the JAX package maps over row chunks.
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
def render_xla(scene, camera: Camera, config: RenderConfig,
               row_chunk: int = 32) -> torch.Tensor:
    """Render a frame on the scene's device: (H, W, 4) int32 for
    framebuffer_dtype "int" (truncated), else float32. A height that is a
    multiple of `row_chunk` (and larger) is traced a block of rows at a
    time; any other frame at once."""
    h, w = config.height, config.width
    o, d = camera.rays(h, w)
    trace = lambda oc, dc: trace_pixels(  # noqa: E731
        scene, oc, dc, shading=config.shading, shadows=config.shadows)
    if h > row_chunk and h % row_chunk == 0:
        rgba = torch.cat([trace(o[r:r + row_chunk], d[r:r + row_chunk])
                          for r in range(0, h, row_chunk)])
    else:
        rgba = trace(o, d)
    return to_int_framebuffer(rgba) if config.framebuffer_dtype == "int" else rgba
