"""Set-up seconds in the optimizer's construction (`parallel.train.
init_train_state`: the program's counter train.optimizer_s; Adam's first
construction in a process imports torch._dynamo), on the host's clock."""


def read(run):
    try:
        from opencl_ray_tracer_tpu_torch.utils import tracing
    except ImportError:  # a program without its recorder
        return None
    return run.memo("program_snapshot", tracing.snapshot)["counters"].get("train.optimizer_s")
