"""B4's share of its roofline (`kernels/csrc/soft_tiled.cu`, the kernel
function soft_fwd_kernel): the least time of a fit step's soft forward
(`roofline.counts.soft_step` at the fit's start) times B4's launches over
B4's device time in the trace, in percent. Steps that took the brute branch
(B6/B7) launch no B4 and are not counted."""

from rtbench.lib import bounds, trace


def read(run):
    if not run.trace:
        return None
    secs, n = trace.kernel(run.trace, "soft_fwd_kernel")
    if not n or secs <= 0:
        return None
    (b4, by), _ = run.memo("soft_bounds", lambda: bounds.soft_step(run))
    run.note(f"B4: {n} launches, {secs:.6e} s on the card, bound {b4:.6e} s "
             f"a step by {by}")
    return 100.0 * n * b4 / secs
