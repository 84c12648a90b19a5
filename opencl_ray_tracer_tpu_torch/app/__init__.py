from opencl_ray_tracer_tpu_torch.app.state import State, StateManager
from opencl_ray_tracer_tpu_torch.app.input import ButtonState, InputManager
from opencl_ray_tracer_tpu_torch.app.main_state import MainState
from opencl_ray_tracer_tpu_torch.app.frame import run_interactive, run_scripted

__all__ = [
    "State",
    "StateManager",
    "ButtonState",
    "InputManager",
    "MainState",
    "run_interactive",
    "run_scripted",
]
