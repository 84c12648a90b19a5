"""Device operations (kernels, copies, fills) a frame, in the traced
stretch: what the host dispatches for one frame, from `models.renderer`
down through `kernels.fwd_tiled`'s binning and gather to B1."""


def read(run):
    t = run.trace
    return t["n_ops"] / t["units"] if t and t["units"] else None
