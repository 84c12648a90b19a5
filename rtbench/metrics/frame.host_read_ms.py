"""Host time a frame waiting for the card at binning's overflow read (the
program's span frame.bin.host_read: `bool(bins.overflow)`, which returns
once the card has drained its queue), in the traced stretch, which the
profiler slows (`utils.tracing`, on the host's clock)."""


def read(run):
    try:
        from opencl_ray_tracer_tpu_torch.utils import tracing
    except ImportError:  # a program without its recorder
        return None
    t = run.trace
    if not t or not t["units"]:
        return None
    s = run.memo("program_snapshot", tracing.snapshot)["spans"].get("frame.bin.host_read")
    return None if s is None else 1e3 * s["total_s"] / t["units"]
