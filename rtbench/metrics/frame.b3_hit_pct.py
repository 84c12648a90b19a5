"""The share of the pixels the brute kernel B3 worked, over the whole run,
that hit something, and so paid the shading and one shadow walk a light:
the card's counters `b3.hit_px` over `b3.px` (`kernels/csrc/fwd_brute.cu`,
one add a block of each launch that runs, eager or replayed), in percent.
A program without the counters, or a run in which B3 never ran, reads
nothing."""


def read(run):
    try:
        from opencl_ray_tracer_tpu_torch.utils import tracing
    except ImportError:  # a program without its recorder
        return None
    c = run.memo("program_snapshot", tracing.snapshot)["counters"]
    px = c.get("b3.px")
    hit = c.get("b3.hit_px")
    if hit is None or not px:  # no counters, or no B3 launch that ran
        return None
    return 100.0 * hit / px
