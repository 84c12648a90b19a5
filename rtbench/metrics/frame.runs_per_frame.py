"""The runs of the whole hard frame a frame, over the whole run: the
program's counter `frame.runs` (`kernels.fwd_tiled.render_tiled`, one a run
of the frame at a K pair, eager or replayed) over its frames,
`frame.replayed` plus `frame.eager`. 1 where no tile list overflows the
config's K caps; each doubling of the caps adds a run of the frame."""


def read(run):
    try:
        from opencl_ray_tracer_tpu_torch.utils import tracing
    except ImportError:  # a program without its recorder
        return None
    c = run.memo("program_snapshot", tracing.snapshot)["counters"]
    runs = c.get("frame.runs")
    frames = c.get("frame.replayed", 0) + c.get("frame.eager", 0)
    if runs is None or not frames:  # a program that counts no runs
        return None
    return runs / frames
