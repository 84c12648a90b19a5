from opencl_ray_tracer_tpu_torch.runtime.backend import (
    Backend,
    describe_devices,
    resolve_backend,
)

__all__ = [
    "Backend",
    "describe_devices",
    "resolve_backend",
]
