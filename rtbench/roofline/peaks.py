"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W
limit): float32 outside the tensor cores, and device memory."""

PEAK_FP32 = 67e12
PEAK_HBM = 3.35e12


def bound_s(ops: float, nbytes: float):
    """(seconds, "operations" or "bytes"): the least time the card could take,
    the larger of operations over the float32 peak and bytes over the
    memory peak."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_HBM
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
