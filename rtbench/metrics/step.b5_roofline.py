"""B5's share of its roofline (`kernels/csrc/soft_tiled.cu`, the kernel
function soft_bwd_kernel): the least time of a fit step's soft backward on
the loss's cotangent (`roofline.counts.soft_step` at the fit's start) times
B5's launches over B5's device time in the trace, in percent. Steps that
took the brute branch (B6/B7) launch no B5 and are not counted."""

from rtbench.lib import bounds, trace


def read(run):
    if not run.trace:
        return None
    secs, n = trace.kernel(run.trace, "soft_bwd_kernel")
    if not n or secs <= 0:
        return None
    _, (b5, by) = run.memo("soft_bounds", lambda: bounds.soft_step(run))
    run.note(f"B5: {n} launches, {secs:.6e} s on the card, bound {b5:.6e} s "
             f"a step by {by}; brute-branch launches in the stretch: "
             f"{trace.kernel(run.trace, 'soft_brute_fwd_kernel')[1]}")
    return 100.0 * n * b5 / secs
