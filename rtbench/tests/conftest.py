"""CPU tests of the benchmark harness: small sizes, the port's plain twins
on the CPU, no JAX. Tests that need the card take the `card` fixture, which
skips without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

LIGHTS = {"position": [[60.0, 30.0, 200.0]], "colour": [[1.0, 1.0, 1.0]],
          "intensity": [1.0], "ambient": 0.1, "spec_strength": 0.5,
          "shininess": 32.0}
SMALL_SCENE = {"generator": "random_scene", "n_spheres": 6, "n_cubes": 1,
               "bounds": [120.0, 60.0], "lights": LIGHTS, "layout_seed": 3}
ORBIT = {"centre": [60.0, 30.0, -60.0], "radius": 150.0, "height_offset": -20.0,
         "fov_degrees": 60.0, "frames_per_turn": 12}


@pytest.fixture
def small():
    """Overrides that cut the cells to a 128 x 64 frame of a small scene."""
    return {
        "rt10_1080.fly": {
            "config": {"width": 128, "height": 64, "scene": SMALL_SCENE},
            "traffic": {"orbit": ORBIT, "warmup_seconds": 0.0,
                        "check_frames": 3, "trace_units": 3}},
        "rt10_1080.fit": {
            "config": {"width": 128, "height": 64, "scene": SMALL_SCENE},
            "traffic": {"steps_per_fit": 5, "log_every": 2, "trace_units": 3,
                        "trace_align": 5, "warmup_seconds": 0.0}},
    }


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
