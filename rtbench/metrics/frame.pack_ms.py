"""Host time a frame in `Scene.pack` (the program's span frame.pack, its
self time), in the traced stretch, which the profiler slows: the scene's
transpose and padding (`utils.tracing`, on the host's clock)."""


def read(run):
    try:
        from opencl_ray_tracer_tpu_torch.utils import tracing
    except ImportError:  # a program without its recorder
        return None
    t = run.trace
    if not t or not t["units"]:
        return None
    s = run.memo("program_snapshot", tracing.snapshot)["spans"].get("frame.pack")
    return None if s is None else 1e3 * s["self_s"] / t["units"]
