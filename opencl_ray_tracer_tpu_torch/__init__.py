"""opencl_ray_tracer_tpu_torch — the ray tracer on PyTorch and CUDA.

A port of `opencl_ray_tracer_tpu` (JAX/Pallas) that mirrors its module
paths. Plain tensor code is PyTorch; the kernels (tiled and brute, hard and
soft, forward and backward) are CUDA C++ written for Hopper (kernels/csrc/),
built with nvcc on first use. Every constructor takes an explicit `device=`; a frame runs on the
device its scene lies on (the CUDA kernel on a card, its plain PyTorch twin
on the CPU). This package imports neither jax nor the JAX package.

  scene/     scene model (spheres SoA, cubes, lights) + built-in scene library
  camera     affine ray-bundle cameras (legacy ortho + pinhole)
  ops/       vectorised intersection + shading math (torch)
  ref/       brute-force oracle tracer (reference semantics, host CPU)
  kernels/   binning + coefficient prep (torch) and the CUDA kernels
  bench      the benchmark entry (python -m opencl_ray_tracer_tpu_torch.bench)
  models/    renderer facade (render, Renderer, get_renderer, MSAA)
  runtime/   backend discovery & dispatch (torch.cuda)
  utils/     logging, timers, RNG, image/PNG IO (stdlib zlib), memory and
             platform info, terminal display, texture compositing
  app/       app shell: state machine, input, frame loop, benchmark harness
"""

__version__ = "0.1.0"

from opencl_ray_tracer_tpu_torch.config import RenderConfig, Settings
from opencl_ray_tracer_tpu_torch.camera import (
    Camera,
    legacy_ortho_camera,
    pinhole_camera,
)
from opencl_ray_tracer_tpu_torch.scene import (
    Cube,
    Lights,
    Scene,
    create_scene,
    create_scene1,
    create_scene2,
    create_scene3,
    random_scene,
    scene_from_arrays,
    scene_to_arrays,
)
from opencl_ray_tracer_tpu_torch.models import Renderer, get_renderer, render
from opencl_ray_tracer_tpu_torch.runtime import (
    Backend,
    available_backends,
    default_backend,
)

__all__ = [
    "RenderConfig",
    "Settings",
    "Camera",
    "legacy_ortho_camera",
    "pinhole_camera",
    "Scene",
    "Cube",
    "Lights",
    "create_scene",
    "create_scene1",
    "create_scene2",
    "create_scene3",
    "random_scene",
    "scene_from_arrays",
    "scene_to_arrays",
    "Renderer",
    "get_renderer",
    "render",
    "Backend",
    "available_backends",
    "default_backend",
]
