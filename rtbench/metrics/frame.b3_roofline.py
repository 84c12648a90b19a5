"""B3's share of its roofline (`kernels/csrc/fwd_brute.cu`, the kernel
function fwd_brute_kernel): the least time of the traced frames' work (the
same count of the reference's work that `frame.b1_roofline` takes, so the
share reads the same work whichever kernel does it) over B3's device time
in the trace, in percent; nothing unless B3 launched once a traced frame."""

from rtbench.lib import bounds, trace


def read(run):
    if not run.trace:
        return None
    secs, n = trace.kernel(run.trace, "fwd_brute_kernel")
    keys = run.inputs.get("frame_keys", [])
    if not n or n != len(keys) or secs <= 0:
        return None
    least = run.memo("b1_bounds", lambda: bounds.hard_frames(run))
    by = sorted({b for _, b in least})
    run.note(f"B3: {n} launches, {secs:.6e} s on the card, bound "
             f"{sum(s for s, _ in least):.6e} s by {'/'.join(by)}")
    return 100.0 * sum(s for s, _ in least) / secs
