from opencl_ray_tracer_tpu_torch.runtime.backend import (
    Backend,
    available_backends,
    card_or,
    default_backend,
    default_device,
    describe_devices,
    log_devices,
    on_accelerator,
    resolve_backend,
)

__all__ = [
    "Backend",
    "available_backends",
    "card_or",
    "default_backend",
    "default_device",
    "describe_devices",
    "log_devices",
    "on_accelerator",
    "resolve_backend",
]
