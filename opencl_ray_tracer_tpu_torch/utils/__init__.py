from opencl_ray_tracer_tpu_torch.utils.log import (
    get_logger,
    log_error,
    log_info,
    log_warning,
    set_level,
)
from opencl_ray_tracer_tpu_torch.utils.timer import (
    DeltaTime,
    PerformanceCounter,
    SimpleTimer,
    now_ns,
    time_fn,
)
from opencl_ray_tracer_tpu_torch.utils.display import render_ansi, show
from opencl_ray_tracer_tpu_torch.utils.image import (
    pack_rgba,
    read_png,
    unpack_words,
    write_png,
)
from opencl_ray_tracer_tpu_torch.utils import (
    mathutil,
    memory,
    platform_info,
    profiling,
    rng,
    tracing,
)

__all__ = [
    "get_logger",
    "log_error",
    "log_info",
    "log_warning",
    "set_level",
    "DeltaTime",
    "PerformanceCounter",
    "SimpleTimer",
    "now_ns",
    "time_fn",
    "pack_rgba",
    "read_png",
    "render_ansi",
    "show",
    "unpack_words",
    "write_png",
    "mathutil",
    "memory",
    "platform_info",
    "profiling",
    "rng",
    "tracing",
]
