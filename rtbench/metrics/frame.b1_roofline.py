"""B1's share of its roofline (`kernels/csrc/fwd_tiled.cu`, the kernel
function fwd_tiled_kernel): the least time of the traced frames' work
(`roofline.counts.hard_frame`, from the reference's counts of each frame's
camera) over B1's device time in the trace, in percent."""

from rtbench.lib import bounds, trace


def read(run):
    if not run.trace:
        return None
    secs, n = trace.kernel(run.trace, "fwd_tiled_kernel")
    keys = run.inputs.get("frame_keys", [])
    if not n or n != len(keys) or secs <= 0:
        return None
    least = run.memo("b1_bounds", lambda: bounds.hard_frames(run))
    by = sorted({b for _, b in least})
    run.note(f"B1: {n} launches, {secs:.6e} s on the card, bound "
             f"{sum(s for s, _ in least):.6e} s by {'/'.join(by)}")
    return 100.0 * sum(s for s, _ in least) / secs
