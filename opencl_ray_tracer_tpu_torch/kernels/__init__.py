from opencl_ray_tracer_tpu_torch.kernels.fwd import (
    render_pallas,
    render_pallas_packed,
)
from opencl_ray_tracer_tpu_torch.kernels.fwd_tiled import (
    TileBins,
    bin_scene,
    render_tiled,
    render_tiled_packed,
    tiled_kernel,
)

__all__ = [
    "render_pallas",
    "render_pallas_packed",
    "TileBins",
    "bin_scene",
    "render_tiled",
    "render_tiled_packed",
    "tiled_kernel",
]
