"""KiB a step that the train step's exchange carries: the program's
counters `mesh.all_reduce_bytes` over `mesh.all_reduces` (`parallel.mesh`:
one exchange of the flat buffer of the loss and every leaf's gradient an
eager step or a replay), over the whole run."""


def read(run):
    try:
        from opencl_ray_tracer_tpu_torch.utils import tracing
    except ImportError:  # a program without its recorder
        return None
    c = run.memo("program_snapshot", tracing.snapshot)["counters"]
    nbytes, n = c.get("mesh.all_reduce_bytes"), c.get("mesh.all_reduces")
    if not n or nbytes is None:  # a program that counts no exchange
        return None
    return nbytes / n / 1024.0
