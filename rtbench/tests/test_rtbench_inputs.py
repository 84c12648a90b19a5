"""Inputs made from the seed: the same seed gives the same scene, orbit and
perturbation; with a layout seed every run seed renders the same primitives
in another order."""

import torch

from rtbench.lib import scenes
from rtbench.lib import files

CPU = torch.device("cpu")
SPEC = {"generator": "random_scene", "n_spheres": 10, "n_cubes": 2,
        "bounds": [1910.0, 1070.0], "layout_seed": 5,
        "lights": {"position": [[200.0, 100.0, 200.0]], "colour": [[1.0, 1.0, 1.0]],
                   "intensity": [1.0], "ambient": 0.1, "spec_strength": 0.5,
                   "shininess": 32.0}}


def _same(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_scene_is_the_seeds():
    a = scenes.make_scene(SPEC, 2 ** 31 + 12345, CPU)
    assert _same(a, scenes.make_scene(SPEC, 2 ** 31 + 12345, CPU))
    assert not _same(a, scenes.make_scene(dict(SPEC, layout_seed=6), 2 ** 31 + 12345, CPU))
    assert a["tri_verts"].shape == (24, 3, 3) and a["sphere_origin"].shape == (10, 3)
    so = a["sphere_origin"]
    assert (so[:, 0] >= 0).all() and (so[:, 0] <= 1910).all()
    assert (so[:, 2] <= -20).all() and (so[:, 2] >= -100).all()
    r = a["sphere_radius"]
    assert (r >= 5).all() and (r <= 30).all()
    # a cube's 12 triangles span a cube: every vertex at the same distance
    # from the cube's centre
    v = a["tri_verts"][:12].reshape(-1, 3)
    d = torch.linalg.vector_norm(v - v.mean(0), dim=1)
    assert torch.allclose(d, d[0].expand_as(d), rtol=1e-4)


def test_layout_seed_keeps_the_primitives_and_reorders_them():
    spec = SPEC
    a = scenes.make_scene(spec, 11, CPU)
    b = scenes.make_scene(spec, 12, CPU)
    assert not torch.equal(a["sphere_origin"], b["sphere_origin"])
    for k in ("sphere_radius",):
        assert torch.equal(a[k].sort().values, b[k].sort().values)
    key = lambda t: sorted(map(tuple, t.reshape(t.shape[0], -1).tolist()))  # noqa: E731
    for k in ("sphere_origin", "tri_verts", "tri_colour"):
        assert key(a[k]) == key(b[k])
    assert _same(a, scenes.make_scene(spec, 11, CPU))


def test_perturbation_is_the_seeds():
    base = scenes.make_scene(SPEC, 3, CPU)
    rule = {"origin_sigma": 20.0, "radius_scale": 0.25, "colour_sigma": 0.15}
    p = scenes.perturb(base, rule, 4)
    assert _same(p, scenes.perturb(base, rule, 4))
    assert not _same(p, scenes.perturb(base, rule, 5))
    assert torch.equal(p["tri_verts"], base["tri_verts"])
    ratio = p["sphere_radius"] / base["sphere_radius"]
    assert (ratio >= 0.75 - 1e-6).all() and (ratio <= 1.25 + 1e-6).all()
    assert (p["sphere_colour"][:, :3] >= 0.05).all()
    assert torch.equal(p["sphere_colour"][:, 3], base["sphere_colour"][:, 3])


def test_orbit_is_the_seeds():
    fr = files.load("loops", "frames")
    orbit = files.traffic("fly")["orbit"]
    cams = fr.orbit_cameras(orbit, 1920, 1080)
    assert len(cams) == orbit["frames_per_turn"]
    for c in cams:
        dist = sum((p - q) ** 2 for p, q in zip(c["position"], orbit["centre"]))
        assert abs(dist - orbit["radius"] ** 2 - orbit["height_offset"] ** 2) < 1e-3
    order = fr.frame_order(orbit, 17)
    assert [order(i) for i in range(3)] == [17, 18, 19]
    assert order(orbit["frames_per_turn"]) == 17
