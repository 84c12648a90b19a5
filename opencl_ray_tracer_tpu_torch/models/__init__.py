from opencl_ray_tracer_tpu_torch.models.renderer import Renderer, get_renderer, render

__all__ = ["Renderer", "get_renderer", "render"]
