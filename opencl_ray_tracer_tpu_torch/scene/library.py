"""Built-in scene library — scenes 1-3 of the reference, plus generators.

Mirrors states/MainState.cpp:419-639:
  scene 1: 2 spheres + 4 cubes, fully deterministic (createScene1, :419-462)
  scene 2: 8 spheres + 10 cubes, fixed geometry, random colours + 6 random-
           coloured cubes (createScene2, :464-594)
  scene 3: 100 random spheres + 100 random cubes (createScene3, :596-639)

The reference seeds its RNG from time(NULL) (main.cpp:41) so scenes 2-3 are
unreproducible run to run; here every scene takes an explicit seed
(default 0) so the same scene is bitwise identical everywhere — which is what
the dual-backend cross-check (SURVEY.md §4.1) needs. The numbers come from
the same numpy generator as in the JAX package, so a seed gives
bit-identical arrays in both. Every builder takes the device its tensors
are made on.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from opencl_ray_tracer_tpu_torch.scene.cube import Cube
from opencl_ray_tracer_tpu_torch.scene.scene import Lights, Scene
from opencl_ray_tracer_tpu_torch.utils.rng import Random


def _rad(deg: float) -> float:
    """Utility::convertAngleToRadian (misc/Utility.cpp:343-347)."""
    return deg * math.pi / 180.0


def _rand_colour(rng: Random) -> list:
    return [
        rng.get_float(0.05, 1.0),
        rng.get_float(0.05, 1.0),
        rng.get_float(0.05, 1.0),
        255.0,
    ]


def create_scene1(*, device, lights: Optional[Lights] = None) -> Scene:
    """Tiny deterministic scene (MainState.cpp:419-462)."""
    sphere_origin = [[300.0, 250.0, -85.0], [500.0, 250.0, -85.0]]
    sphere_radius = [50.0, 30.0]
    sphere_colour = [[0.0, 1.0, 1.0, 255.0], [1.0, 0.0, 1.0, 255.0]]

    cubes = []
    c1 = Cube([1.0, 1.0, 0.0, 255.0])
    c1.scale(40.0).rotate((0, 0, _rad(30))).rotate((0, _rad(30), 0))
    c1.translate((70.0, 60.0, -60.0))
    cubes.append(c1)

    c2 = Cube([0.0, 1.0, 1.0, 255.0])
    c2.scale(30.0).rotate((0, 0, _rad(80))).rotate((0, _rad(250), 0))
    c2.translate((150.0, 60.0, -70.0))
    cubes.append(c2)

    c3 = Cube([0.0, 0.0, 1.0, 255.0])
    c3.scale(10.0).rotate((0, 0, _rad(160))).rotate((_rad(210), 0, 0))
    c3.translate((150.0, 400.0, -40.0))
    cubes.append(c3)

    c4 = Cube([1.0, 0.0, 0.0, 255.0])
    c4.scale(50.0).rotate((0, 0, _rad(80))).rotate((0, _rad(250), 0))
    c4.translate((450.0, 200.0, -80.0))
    cubes.append(c4)

    return Scene.build(
        device=device,
        sphere_origin=sphere_origin,
        sphere_radius=sphere_radius,
        sphere_colour=sphere_colour,
        cubes=cubes,
        lights=lights,
    )


def create_scene2(
    seed: int = 0, *, device, lights: Optional[Lights] = None
) -> Scene:
    """Medium semi-random scene (MainState.cpp:464-594)."""
    rng = Random(seed)

    sphere_origin = [
        [100.0, 150.0, -85.0],
        [300.0, 400.0, -65.0],
        [350.0, 150.0, -85.0],
        [200.0, 250.0, -85.0],
        [200.0, 350.0, -45.0],
        [600.0, 450.0, -125.0],
        [20.0, 450.0, -64.0],
        [620.0, 250.0, -115.0],
    ]
    sphere_radius = [50.0, 30.0, 15.0, 25.0, 20.0, 42.0, 42.0, 32.0]
    sphere_colour = [_rand_colour(rng) for _ in sphere_radius]

    cubes = []
    # Cubes 1-4 are identical to scene 1's (MainState.cpp:504-537).
    c1 = Cube([1.0, 1.0, 0.0, 255.0])
    c1.scale(40.0).rotate((0, 0, _rad(30))).rotate((0, _rad(30), 0))
    c1.translate((70.0, 60.0, -60.0))
    cubes.append(c1)

    c2 = Cube([0.0, 1.0, 1.0, 255.0])
    c2.scale(30.0).rotate((0, 0, _rad(80))).rotate((0, _rad(250), 0))
    c2.translate((150.0, 60.0, -70.0))
    cubes.append(c2)

    c3 = Cube([0.0, 0.0, 1.0, 255.0])
    c3.scale(10.0).rotate((0, 0, _rad(160))).rotate((_rad(210), 0, 0))
    c3.translate((150.0, 400.0, -40.0))
    cubes.append(c3)

    c4 = Cube([1.0, 0.0, 0.0, 255.0])
    c4.scale(50.0).rotate((0, 0, _rad(80))).rotate((0, _rad(250), 0))
    c4.translate((450.0, 200.0, -80.0))
    cubes.append(c4)

    c5 = Cube(_rand_colour(rng))
    c5.scale(30.0).rotate((_rad(170), 0, 0)).rotate((0, _rad(150), 0))
    c5.translate((450.0, 400.0, -60.0))
    cubes.append(c5)

    c6 = Cube(_rand_colour(rng))
    c6.scale(50.0).rotate((0, 0, _rad(80))).rotate((_rad(350), 0, 0))
    c6.translate((50.0, 300.0, -100.0))
    cubes.append(c6)

    c7 = Cube(_rand_colour(rng))
    c7.scale(70.0).rotate((_rad(160), 0, 0)).rotate((0, _rad(250), 0))
    c7.translate((530.0, 300.0, -100.0))
    cubes.append(c7)

    c8 = Cube(_rand_colour(rng))
    c8.scale(25.0).rotate((0, 0, _rad(190))).rotate((0, _rad(140), 0))
    c8.translate((230.0, 150.0, -40.0))
    cubes.append(c8)

    c9 = Cube(_rand_colour(rng))
    # Note the reference's quirky rotate chain incl. a raw 9.9 rad z term
    # (MainState.cpp:574-577) — preserved.
    c9.scale(50.0).rotate((0, _rad(130), 0)).rotate((_rad(150), 0, 9.9))
    c9.rotate((0, 0, _rad(50)))
    c9.translate((510.0, 50.0, -90.0))
    cubes.append(c9)

    c10 = Cube(_rand_colour(rng))
    c10.scale(24.0).rotate((0, 0, _rad(280))).rotate((0, _rad(20), 0))
    c10.translate((350.0, 340.0, -40.0))
    cubes.append(c10)

    return Scene.build(
        device=device,
        sphere_origin=sphere_origin,
        sphere_radius=sphere_radius,
        sphere_colour=sphere_colour,
        cubes=cubes,
        lights=lights,
    )


def create_scene3(
    seed: int = 0, *, device, lights: Optional[Lights] = None
) -> Scene:
    """100 random spheres + 100 random cubes stress scene
    (MainState.cpp:596-639)."""
    return random_scene(100, 100, seed=seed, lights=lights, device=device)


def random_scene(
    n_spheres: int,
    n_cubes: int,
    seed: int = 0,
    lights: Optional[Lights] = None,
    bounds=(630.0, 470.0),
    *,
    device,
) -> Scene:
    """Generalized scene-3 generator: any primitive count, any extent.

    Uses the reference's exact parameter distributions (MainState.cpp:599-638):
    positions uniform in the view rect, z in -[20,100] (spheres) / -[30,100]
    (cubes), radii/scales uniform [5,30], colours uniform [0.05,1].
    """
    rng = Random(seed)
    bx, by = bounds

    sphere_origin, sphere_radius, sphere_colour = [], [], []
    for _ in range(n_spheres):
        sphere_origin.append(
            [rng.get_float(0, bx), rng.get_float(0, by), -rng.get_float(20, 100)]
        )
        sphere_radius.append(rng.get_float(5, 30))
        sphere_colour.append(_rand_colour(rng))

    cubes = []
    for _ in range(n_cubes):
        c = Cube(_rand_colour(rng))
        c.scale(rng.get_float(5, 30))
        c.rotate((0, 0, _rad(rng.get_float(0, 359))))
        c.rotate((0, _rad(rng.get_float(0, 359)), 0))
        c.rotate((_rad(rng.get_float(0, 359)), 0, 0))
        c.translate(
            [rng.get_float(0, bx), rng.get_float(0, by), -rng.get_float(30, 100)]
        )
        cubes.append(c)

    return Scene.build(
        device=device,
        sphere_origin=np.asarray(sphere_origin, np.float32).reshape(n_spheres, 3),
        sphere_radius=sphere_radius,
        sphere_colour=np.asarray(sphere_colour, np.float32).reshape(n_spheres, 4),
        cubes=cubes,
        lights=lights,
    )


def create_scene(
    number: int, seed: int = 0, *, device, lights: Optional[Lights] = None
) -> Scene:
    """Scene dispatch, the F2 cycle (MainState.cpp:186-210)."""
    if number == 1:
        return create_scene1(lights=lights, device=device)
    if number == 2:
        return create_scene2(seed=seed, lights=lights, device=device)
    if number == 3:
        return create_scene3(seed=seed, lights=lights, device=device)
    raise ValueError(f"unknown scene number {number} (have 1-3)")
