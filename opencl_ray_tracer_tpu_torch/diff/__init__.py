from opencl_ray_tracer_tpu_torch.diff.soft import (
    render_soft,
    render_soft_jit,
    trace_soft,
)

__all__ = ["render_soft", "render_soft_jit", "trace_soft"]
