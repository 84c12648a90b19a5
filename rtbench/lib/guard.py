"""The run's own checks: the card it needs, and that nothing of JAX or of the
JAX package was loaded into the process that prints the result."""

from __future__ import annotations

import sys

# Top-level module names no benchmark run may load, compared whole: the
# port's own name begins with the JAX package's, so a prefix test is wrong.
FORBIDDEN = ("jax", "jaxlib", "flax", "opencl_ray_tracer_tpu")


def forbidden_loaded(modules=None) -> list:
    """Sorted top-level names in `modules` (sys.modules by default) that are
    in FORBIDDEN, each compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def require_cards(chips: int) -> str:
    """The card's name (which initialises CUDA); raise SystemExit (no
    result) where CUDA is missing or shows fewer cards than the cell asks
    for."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("rtbench: no CUDA device is visible; the benchmark "
                         "runs on the card only")
    n = torch.cuda.device_count()
    if n < chips:
        raise SystemExit(f"rtbench: the cell asks for {chips} cards, "
                         f"{n} are visible")
    return torch.cuda.get_device_name(0)
