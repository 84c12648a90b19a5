"""Scenes and perturbations made from the seed on the device.

The distributions are the reference app's scene 3 (`MainState.cpp:596-639`),
as the port's `scene.library.random_scene` draws them: sphere centres
uniform over the view rectangle at z in -[20, 100], radii uniform in
[5, 30]; cubes scaled uniformly in [5, 30], rotated about z, then y, then x
by angles uniform in [0, 359] degrees, placed at z in -[30, 100]; colours
uniform in [0.05, 1] with alpha 255. The numbers come from a
`torch.Generator` on the device in a few calls, so the same seed gives the
same scene on the same kind of device, but not the numbers the port's
numpy generator would draw. Both sides of a comparison get the arrays made
here.
"""

from __future__ import annotations

import math

import torch

# The 36 unit-cube vertices of the reference's Cube (Cube.cpp:10-45).
UNIT_CUBE = (
    (-1, -1, -1), (-1, -1, 1), (-1, 1, 1), (1, 1, -1), (-1, -1, -1), (-1, 1, -1),
    (1, -1, 1), (-1, -1, -1), (1, -1, -1), (1, 1, -1), (1, -1, -1), (-1, -1, -1),
    (-1, -1, -1), (-1, 1, 1), (-1, 1, -1), (1, -1, 1), (-1, -1, 1), (-1, -1, -1),
    (-1, 1, 1), (-1, -1, 1), (1, -1, 1), (1, 1, 1), (1, -1, -1), (1, 1, -1),
    (1, -1, -1), (1, 1, 1), (1, -1, 1), (1, 1, 1), (1, 1, -1), (-1, 1, -1),
    (1, 1, 1), (-1, 1, -1), (-1, 1, 1), (1, 1, 1), (-1, 1, 1), (1, -1, 1),
)

LIGHT_KEYS = ("position", "colour", "intensity", "ambient", "spec_strength",
              "shininess")
SCENE_KEYS = ("sphere_origin", "sphere_radius", "sphere_colour", "tri_verts",
              "tri_colour")


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _uniform(u, lo, hi):
    return lo + (hi - lo) * u


def _rot(axis: int, a: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotations about one axis (x 0, y 1, z 2) by angles a."""
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    if axis == 0:
        rows = (one, zero, zero, zero, c, -s, zero, s, c)
    elif axis == 1:
        rows = (c, zero, s, zero, one, zero, -s, zero, c)
    else:
        rows = (c, -s, zero, s, c, zero, zero, zero, one)
    return torch.stack(rows, dim=-1).reshape(-1, 3, 3)


def random_scene(n_spheres: int, n_cubes: int, bounds, lights: dict, seed: int,
                 device) -> dict:
    """The flat arrays of a scene (keys SCENE_KEYS and "lights.<key>"),
    float32 on `device`."""
    g = generator(seed, device)
    bx, by = (float(b) for b in bounds)
    f32 = dict(dtype=torch.float32, device=device)
    us = torch.rand((n_spheres, 7), generator=g, **f32)
    origin = torch.stack([_uniform(us[:, 0], 0, bx), _uniform(us[:, 1], 0, by),
                          -_uniform(us[:, 2], 20, 100)], dim=1)
    radius = _uniform(us[:, 3], 5, 30)
    alpha = torch.full((n_spheres, 1), 255.0, **f32)
    colour = torch.cat([_uniform(us[:, 4:7], 0.05, 1.0), alpha], dim=1)

    uc = torch.rand((n_cubes, 10), generator=g, **f32)
    unit = torch.tensor(UNIT_CUBE, **f32)
    rad = lambda u: _uniform(u, 0, 359) * (math.pi / 180.0)  # noqa: E731
    v = unit[None] * _uniform(uc[:, 3], 5, 30)[:, None, None]
    for axis, col in ((2, 4), (1, 5), (0, 6)):
        v = v @ _rot(axis, rad(uc[:, col])).transpose(1, 2)
    shift = torch.stack([_uniform(uc[:, 7], 0, bx), _uniform(uc[:, 8], 0, by),
                         -_uniform(uc[:, 9], 30, 100)], dim=1)
    v = v + shift[:, None, :]
    cube_colour = torch.cat([_uniform(uc[:, 0:3], 0.05, 1.0),
                             torch.full((n_cubes, 1), 255.0, **f32)], dim=1)
    out = {
        "sphere_origin": origin.contiguous(),
        "sphere_radius": radius.contiguous(),
        "sphere_colour": colour.contiguous(),
        "tri_verts": v.reshape(n_cubes * 12, 3, 3).contiguous(),
        "tri_colour": cube_colour.repeat_interleave(12, dim=0).contiguous(),
    }
    for k in LIGHT_KEYS:
        out[f"lights.{k}"] = torch.tensor(lights[k], **f32)
    return out


def make_scene(spec: dict, seed: int, device) -> dict:
    """A configuration's "scene" entry -> its arrays for this run's seed.

    The primitives are drawn from the entry's "layout_seed", the
    deployment's own scene, and the run's seed orders them (spheres and
    cubes each in an order drawn from it): every seed renders the same set
    of primitives, so the work of a frame or a step does not change with the
    seed, while ties and the order of every candidate list do."""
    if spec["generator"] != "random_scene":
        raise ValueError(f"unknown scene generator {spec['generator']!r}")
    arrays = random_scene(spec["n_spheres"], spec["n_cubes"], spec["bounds"],
                          spec["lights"], spec["layout_seed"], device)
    return reorder(arrays, seed)


def reorder(arrays: dict, seed: int) -> dict:
    """The same primitives, spheres and cubes each in an order drawn from
    `seed` (a cube's 12 triangles stay together, in their order)."""
    dev = arrays["sphere_origin"].device
    g = generator(seed, dev)
    ps = torch.randperm(arrays["sphere_radius"].shape[0], generator=g, device=dev)
    n_cubes = arrays["tri_verts"].shape[0] // 12
    pc = torch.randperm(n_cubes, generator=g, device=dev)
    tri = (pc[:, None] * 12 + torch.arange(12, device=dev)[None, :]).reshape(-1)
    out = dict(arrays)
    for k in ("sphere_origin", "sphere_radius", "sphere_colour"):
        out[k] = arrays[k][ps].contiguous()
    for k in ("tri_verts", "tri_colour"):
        out[k] = arrays[k][tri].contiguous()
    return out


def perturb(arrays: dict, rule: dict, seed: int) -> dict:
    """A jittered copy, the start of a recovery fit, by the rule of the port's
    `models.inverse.perturb_scene` (kept here as it stands): Gaussian sphere
    origin offsets (sigma `origin_sigma`), radii times 1 + U(-s, s)
    (`radius_scale`), RGB colours plus Gaussian noise (`colour_sigma`)
    clipped to [0.05, 1]; triangles and lights exact. Drawn on the arrays'
    device from `seed`."""
    dev = arrays["sphere_origin"].device
    g = generator(seed, dev)
    so, sr, sc = (arrays[k] for k in ("sphere_origin", "sphere_radius",
                                      "sphere_colour"))
    n = so.shape[0]
    noise = torch.randn((n, 6), generator=g, dtype=torch.float32, device=dev)
    u = torch.rand((n,), generator=g, dtype=torch.float32, device=dev)
    s = float(rule["radius_scale"])
    out = dict(arrays)
    out["sphere_origin"] = so + float(rule["origin_sigma"]) * noise[:, :3]
    out["sphere_radius"] = sr * (1.0 + (-s + 2.0 * s * u))
    rgb = torch.clamp(sc[:, :3] + float(rule["colour_sigma"]) * noise[:, 3:6],
                      0.05, 1.0)
    out["sphere_colour"] = torch.cat([rgb, sc[:, 3:]], dim=1)
    return out
