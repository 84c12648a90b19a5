"""Host time a frame in the camera-dependent coefficient gather
(`kernels.fwd_tiled.kernel_inputs`: the program's span frame.gather, its
self time), in the traced stretch, which the profiler slows
(`utils.tracing`, on the host's clock)."""


def read(run):
    try:
        from opencl_ray_tracer_tpu_torch.utils import tracing
    except ImportError:  # a program without its recorder
        return None
    t = run.trace
    if not t or not t["units"]:
        return None
    s = run.memo("program_snapshot", tracing.snapshot)["spans"].get("frame.gather")
    return None if s is None else 1e3 * s["self_s"] / t["units"]
