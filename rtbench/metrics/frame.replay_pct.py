"""The share of the hard tiled frames, over the whole run, that the program
replayed as a CUDA graph in place of running them eagerly: its counters
`frame.replayed` and `frame.eager` (`kernels.fwd_tiled.render_tiled`, each
frame in one of them), in percent."""


def read(run):
    try:
        from opencl_ray_tracer_tpu_torch.utils import tracing
    except ImportError:  # a program without its recorder
        return None
    c = run.memo("program_snapshot", tracing.snapshot)["counters"]
    replayed, eager = c.get("frame.replayed"), c.get("frame.eager")
    if replayed is None and eager is None:  # a program that counts neither
        return None
    frames = (replayed or 0) + (eager or 0)
    return 100.0 * (replayed or 0) / frames if frames else None
