from opencl_ray_tracer_tpu_torch.kernels.fwd_tiled import (
    TileBins,
    bin_scene,
    render_tiled,
    render_tiled_packed,
    tiled_kernel,
)

__all__ = [
    "TileBins",
    "bin_scene",
    "render_tiled",
    "render_tiled_packed",
    "tiled_kernel",
]
