"""Host time a frame in the app's copy of the frame to the host (the
program's span app.readback in `app.main_state.MainState.run_trace`, its
self time), in the traced stretch, which the profiler slows; nothing where
the app keeps the frame on the card (no such span)."""


def read(run):
    try:
        from opencl_ray_tracer_tpu_torch.utils import tracing
    except ImportError:  # a program without its recorder
        return None
    t = run.trace
    if not t or not t["units"]:
        return None
    s = run.memo("program_snapshot", tracing.snapshot)["spans"].get("app.readback")
    return None if s is None else 1e3 * s["self_s"] / t["units"]
