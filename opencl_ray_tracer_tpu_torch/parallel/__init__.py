from opencl_ray_tracer_tpu_torch.parallel.train import (
    TrainState,
    adam,
    init_train_state,
    make_train_step,
    scene_leaves,
)

__all__ = [
    "TrainState",
    "adam",
    "init_train_state",
    "make_train_step",
    "scene_leaves",
]
