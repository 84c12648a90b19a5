from opencl_ray_tracer_tpu_torch.utils.log import (
    get_logger,
    log_error,
    log_info,
    log_warning,
    set_level,
)
from opencl_ray_tracer_tpu_torch.utils.image import (
    pack_rgba,
    read_png,
    unpack_words,
    write_png,
)
from opencl_ray_tracer_tpu_torch.utils import rng

__all__ = [
    "get_logger",
    "log_error",
    "log_info",
    "log_warning",
    "set_level",
    "pack_rgba",
    "read_png",
    "unpack_words",
    "write_png",
    "rng",
]
