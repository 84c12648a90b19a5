"""Set-up seconds in the capture of the compiled train step, warm-up
included (`runtime.graph.capture`: the program's counter graph.capture_s),
on the host's clock."""


def read(run):
    try:
        from opencl_ray_tracer_tpu_torch.utils import tracing
    except ImportError:  # a program without its recorder
        return None
    return run.memo("program_snapshot", tracing.snapshot)["counters"].get("graph.capture_s")
