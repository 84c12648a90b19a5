from opencl_ray_tracer_tpu_torch.ref.tracer import render_reference

__all__ = ["render_reference"]
