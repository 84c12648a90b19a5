"""Renderer facade — the model families of this framework.

A "model" here is a renderer configuration: shading model x backend. The
facade dispatches to:

  reference -> ref/tracer.py           (brute-force oracle on the host CPU,
                                        returning a CPU tensor)
  pallas    -> kernels/fwd_tiled.py    (the tiled hard kernel: CUDA on the
                                        card, its plain twin on the CPU)
  xla       -> models/xla_backend.py  (the whole frame in plain torch ops)
  soft + pallas -> kernels/soft.py render_soft_pallas (the tiled soft
                   kernels, forward and backward)
  soft + other  -> diff/soft.py render_soft (the torch-autograd oracle)

Every other frame runs on the device the scene's tensors lie on.

`render_jit(config)` is the compiled tiled frame: forward(scene, camera) at
the config's K caps with no host read, captured as a CUDA graph on the card
(runtime/graph.py), the brute kernel taking over on the card where a tile's
list overflows, as the JAX package's `render_tiled` does under `jax.jit`.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import torch

from opencl_ray_tracer_tpu_torch.camera import Camera, legacy_ortho_camera
from opencl_ray_tracer_tpu_torch.config import RenderConfig
from opencl_ray_tracer_tpu_torch.ops.shading import pack_framebuffer_words
from opencl_ray_tracer_tpu_torch.runtime import Backend, resolve_backend

# Sub-pixel sample offsets per MSAA level, in pixel units relative to the
# pixel's nominal sample point: 2x diagonal pair, 4x rotated grid (RGSS),
# 8x/16x 8-rook / 4x4 ordered grid.
MSAA_OFFSETS = {
    2: ((0.25, 0.25), (-0.25, -0.25)),
    4: ((-0.125, -0.375), (0.375, -0.125), (-0.375, 0.125), (0.125, 0.375)),
    8: tuple(
        ((i + 0.5) / 8.0 - 0.5, (((i * 3) % 8) + 0.5) / 8.0 - 0.5)
        for i in range(8)
    ),
    16: tuple(
        ((ix + 0.5) / 4.0 - 0.5, (iy + 0.5) / 4.0 - 0.5)
        for iy in range(4)
        for ix in range(4)
    ),
}


def render(
    scene,
    camera: Optional[Camera] = None,
    config: Optional[RenderConfig] = None,
    backend: Union[Backend, str, None] = None,
) -> torch.Tensor:
    """Render a frame on the scene's device (on the host CPU for backend
    "reference"). Returns (H, W, 4) int32 or float32, or (H, W) int32 words
    for framebuffer_dtype "packed".

    config.msaa > 1 supersamples: `msaa` sub-pixel-jittered renders through
    the affine camera bundle, box-filtered, quantised once at the end
    (resolve-then-quantise, the GL multisample-resolve order)."""
    config = config or RenderConfig()
    camera = camera or legacy_ortho_camera(device=scene.device)

    if config.msaa > 1:
        sample_cfg = config.replace(msaa=0, framebuffer_dtype="float")
        acc = None
        for dx, dy in MSAA_OFFSETS[config.msaa]:
            img = render(scene, camera.shift_subpixel(dx, dy), sample_cfg,
                         backend=backend)
            acc = img if acc is None else acc + img
        out = acc * (1.0 / config.msaa)
        if config.framebuffer_dtype == "int":
            out = torch.round(out).to(torch.int32)
        elif config.framebuffer_dtype == "packed":
            out = pack_framebuffer_words(torch.round(out))
        return out

    b = resolve_backend(backend if backend is not None else config.backend)

    # Packed framebuffers are native on the tiled hard kernel (it emits the
    # words); every other path renders float and packs.
    if config.framebuffer_dtype == "packed" and (b != Backend.PALLAS
                                                 or config.soft):
        rgba = render(scene, camera, config.replace(framebuffer_dtype="float"),
                      backend=b)
        return pack_framebuffer_words(rgba)

    if config.soft:
        if b == Backend.PALLAS:
            from opencl_ray_tracer_tpu_torch.kernels.soft import render_soft_pallas

            return render_soft_pallas(scene, camera, config)
        from opencl_ray_tracer_tpu_torch.diff import render_soft

        return render_soft(scene, camera, config)
    if b == Backend.XLA:
        from opencl_ray_tracer_tpu_torch.models.xla_backend import render_xla

        return render_xla(scene, camera, config)
    if b == Backend.REFERENCE:
        from opencl_ray_tracer_tpu_torch.ref import render_reference

        return render_reference(scene, camera, config)
    from opencl_ray_tracer_tpu_torch.kernels.fwd_tiled import render_tiled

    return render_tiled(scene, camera, config)


def render_jit(config: RenderConfig) -> Callable:
    """forward(scene, camera) -> the tiled frame of `config` (the formats of
    `render_tiled`), compiled: `kernels.fwd_tiled.render_tiled_fixed` at the
    config's K caps through `runtime.graph.jit`. On the card the first call
    captures a CUDA graph and every call returns the graph's static output
    (clone what you keep); on the CPU it runs the plain twins eagerly."""
    from opencl_ray_tracer_tpu_torch.kernels.fwd_tiled import render_tiled_fixed
    from opencl_ray_tracer_tpu_torch.runtime.graph import jit

    if config.soft or config.msaa > 1:
        raise ValueError("render_jit compiles the hard tiled frame: soft=False, "
                         "msaa <= 1")
    return jit(functools.partial(render_tiled_fixed, config=config))


class Renderer:
    """Stateful facade bundling a config + camera (None: the legacy ortho
    camera on the scene's device), with per-backend render methods."""

    def __init__(
        self,
        config: Optional[RenderConfig] = None,
        camera: Optional[Camera] = None,
    ):
        self.config = (config or RenderConfig()).validate()
        self.camera = camera

    def render(self, scene, backend: Union[Backend, str, None] = None) -> torch.Tensor:
        return render(scene, self.camera, self.config, backend=backend)

    def render_cpu(self, scene) -> torch.Tensor:
        """The reference's CPU mode (executeRayTracerCPU): the oracle on the
        host CPU."""
        return self.render(scene, backend=Backend.REFERENCE)

    def render_accelerated(self, scene) -> torch.Tensor:
        """The reference's OpenCL mode (executeRayTracerOpenCL)."""
        return self.render(scene, backend=None)


def get_renderer(family: str, width: int = 640, height: int = 480, **kw) -> Renderer:
    """Renderer families by name:

    legacy         — exact reference pipeline (depth fog, int framebuffer)
    lambert        — point lights + Lambertian diffuse
    phong          — Phong + hard shadows
    soft / diff    — soft-edge differentiable renderer
    """
    presets = {
        "legacy": dict(shading="legacy", framebuffer_dtype="int"),
        "lambert": dict(shading="lambert", framebuffer_dtype="float"),
        "phong": dict(shading="phong", shadows=True, framebuffer_dtype="float"),
        "soft": dict(shading="lambert", soft=True, framebuffer_dtype="float"),
        "diff": dict(shading="lambert", soft=True, framebuffer_dtype="float"),
    }
    if family not in presets:
        raise ValueError(f"unknown renderer family {family!r}; have {list(presets)}")
    opts = {**presets[family], **kw}
    return Renderer(RenderConfig(width=width, height=height, **opts).validate())
