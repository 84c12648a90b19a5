from opencl_ray_tracer_tpu_torch.ops.intersect import (
    EPSILON,
    MISS_T,
    Hit,
    any_hit,
    intersect_spheres,
    intersect_tris,
    nearest_hit,
)
from opencl_ray_tracer_tpu_torch.ops.shading import (
    pack_framebuffer_words,
    shade_lambert,
    shade_legacy,
    shade_phong,
    to_int_framebuffer,
)

__all__ = [
    "EPSILON",
    "MISS_T",
    "Hit",
    "any_hit",
    "intersect_spheres",
    "intersect_tris",
    "nearest_hit",
    "pack_framebuffer_words",
    "shade_lambert",
    "shade_legacy",
    "shade_phong",
    "to_int_framebuffer",
]
