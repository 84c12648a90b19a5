"""Seeded RNG utility — the reference's Random wrapper (misc/Random.cpp:10-42).

Backed by numpy's PCG64 exactly as in the JAX package, so the scene library
draws the same numbers from the same seed and both packages build
bit-identical scenes.
"""

from __future__ import annotations

import numpy as np

from opencl_ray_tracer_tpu_torch.utils.log import log_warning


class Random:
    """Instance RNG with the reference's getInt/getFloat surface."""

    def __init__(self, seed: int | None = None):
        self._gen: np.random.Generator | None = None
        if seed is not None:
            self.init(seed)

    def init(self, seed: int) -> None:
        self._gen = np.random.default_rng(seed)

    def _require(self) -> np.random.Generator:
        if self._gen is None:
            # Reference warns and carries on with an unseeded stream
            # (Random.cpp:24-27); we do the same.
            log_warning("Random used before init(); seeding from entropy")
            self._gen = np.random.default_rng()
        return self._gen

    def get_int(self, lo: int, hi: int) -> int:
        """Inclusive range, like rand() % (hi - lo + 1) + lo."""
        return int(self._require().integers(lo, hi + 1))

    def get_float(self, lo: float, hi: float) -> float:
        return float(self._require().uniform(lo, hi))


# Module-level singleton mirroring the reference's static class
# (misc/Random.cpp), as the JAX package's utils/rng.py keeps one.
_global = Random()


def init(seed: int) -> None:
    _global.init(seed)


def get_int(lo: int, hi: int) -> int:
    return _global.get_int(lo, hi)


def get_float(lo: float, hi: float) -> float:
    return _global.get_float(lo, hi)
