"""The reference against hand-worked small cases."""

import math

import pytest
import torch

from rtbench.reference import camera, fit, hard, soft

LIGHTS = {"lights.position": torch.tensor([[0.0, 0.0, 100.0]]),
          "lights.colour": torch.tensor([[1.0, 1.0, 1.0]]),
          "lights.intensity": torch.tensor([1.0]),
          "lights.ambient": torch.tensor(0.1),
          "lights.spec_strength": torch.tensor(0.5),
          "lights.shininess": torch.tensor(32.0)}


def one_sphere(x=2.0, y=1.0, z=-50.0, r=1.5):
    return {"sphere_origin": torch.tensor([[x, y, z]]), "sphere_radius": torch.tensor([r]),
            "sphere_colour": torch.tensor([[1.0, 0.5, 0.25, 255.0]]),
            "tri_verts": torch.zeros((0, 3, 3)), "tri_colour": torch.zeros((0, 4)),
            **LIGHTS}


def test_ortho_rays_and_pinhole_centre():
    o, d = camera.rays({"kind": "ortho"}, slice(2, 4), 3, "cpu")
    assert o[1, 2].tolist() == [2.0, 3.0, 0.0] and d[0, 0].tolist() == [0.0, 0.0, -1.0]
    cam = {"kind": "pinhole", "position": (0.0, 0.0, 10.0), "look_at": (0.0, 0.0, 0.0),
           "up": (0.0, 1.0, 0.0), "fov_degrees": 90.0, "width": 2, "height": 2}
    o, d = camera.rays(cam, slice(0, 2), 2, "cpu")
    # pixel centres at +-0.5 of a plane one unit ahead whose half width is 1
    assert d[0, 0].tolist() == pytest.approx([-0.5 / math.sqrt(1.5), 0.5 / math.sqrt(1.5),
                                              -1.0 / math.sqrt(1.5)], abs=1e-6)
    assert (o == torch.tensor([0.0, 0.0, 10.0])).all()


def test_legacy_hit_depth_and_colour():
    s = one_sphere()
    img = hard.render(s, {"kind": "ortho"}, 3, 4, "legacy", False)
    # pixel (x=2, y=1) hits the sphere's front at t = 50 - 1.5 = 48.5
    scale = 255.0 - 48.5 / 180.0 * 255.0
    assert img[1, 2, :3].tolist() == pytest.approx([scale, 0.5 * scale, 0.25 * scale])
    assert img[0, 0].tolist() == [0.0, 0.0, 0.0, 255.0]


def test_triangle_hit_and_sphere_wins_only_strictly():
    tri = torch.tensor([[[0.0, 0.0, -10.0], [4.0, 0.0, -10.0], [0.0, 4.0, -10.0]]])
    s = {**one_sphere(x=1.0, y=1.0, z=-20.0, r=1.0), "tri_verts": tri,
         "tri_colour": torch.tensor([[0.0, 1.0, 0.0, 255.0]])}
    o, d = camera.rays({"kind": "ortho"}, slice(1, 2), 2, "cpu")
    t, colour, normal, hit, _, pairs = hard.nearest(o, d, s)
    assert t[0, 1].item() == pytest.approx(10.0) and colour[0, 1, 1].item() == 1.0
    assert pairs[0, 1].item() == 2 and hit.all()
    assert normal[0, 1].tolist() == pytest.approx([0.0, 0.0, 1.0])


def test_hard_shadow_and_packed_words():
    tri = torch.tensor([[[-5.0, -5.0, -10.0], [5.0, -5.0, -10.0], [-5.0, 5.0, -10.0]]])
    s = {**one_sphere(x=0.0, y=0.0, z=-30.0, r=3.0), "tri_verts": tri,
         "tri_colour": torch.tensor([[0.0, 1.0, 0.0, 255.0]])}
    s["lights.position"] = torch.tensor([[0.0, 0.0, -100.0]])
    img, c = hard.render(s, {"kind": "ortho"}, 1, 1, "lambert", True, with_counts=True)
    # the triangle is hit first; the sphere lies between it and the light
    assert c["occluded"].all() and c["lit"].all()
    assert img[0, 0, :3].tolist() == pytest.approx([0.0, 0.1 * 255.0, 0.0])
    words = hard.pack(img)
    assert hard.unpack(words)[0, 0].tolist() == [0, 25, 0]
    assert words.item() == 25 * 256 - 16777216


def test_soft_coverage_inside_and_far():
    s = one_sphere(r=20.0)
    o = torch.tensor([[2.0, 1.0, 0.0], [200.0, 1.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    oc, dc = tuple(o[:, q:q + 1] for q in range(3)), tuple(d[:, q:q + 1] for q in range(3))
    t, cov, _ = soft.sphere_soft(oc, dc, s, torch.tensor(0.5))
    assert cov[0, 0].item() == pytest.approx(1.0) and cov[1, 0].item() == 0.0
    assert t[0, 0].item() == pytest.approx(30.0, abs=1e-3)
    c = []
    img = soft.trace(s, o, d, shading="lambert", tau_d=torch.tensor(1.0),
                     tau_e=torch.tensor(0.5), shadows=False, counts=c)
    names = dict((k, v.tolist()) for k, v in c)
    assert names["sph"] == [1, 0] and names["covered"] == [True, False]
    assert img[1, :3].tolist() == [0.0, 0.0, 0.0]


def test_fit_loss_and_one_adam_step_by_hand():
    s = one_sphere(r=1.0)
    cfg = {"height": 3, "width": 4, "shading": "lambert", "shadows": False,
           "tau_depth": 1.0, "tau_edge": 0.5}
    target = torch.zeros((3, 4, 4))
    img = soft.render(s, {"kind": "ortho"}, 3, 4, shading="lambert", shadows=False,
                      tau_d=1.0, tau_e=0.5)
    want = float(((img[..., :3] / 255.0) ** 2).mean())
    loss, g = fit.loss_and_grads(s, target, {"kind": "ortho"}, cfg, ["sphere_radius"])
    assert loss == pytest.approx(want, rel=1e-6)
    losses, g1, after = fit.adam_steps(s, target, {"kind": "ortho"}, cfg,
                                       ["sphere_radius"], 0.5, 1)
    # Adam's first step moves each value by lr against the gradient's sign
    assert after["sphere_radius"].item() == pytest.approx(
        1.0 - 0.5 * math.copysign(1.0, g["sphere_radius"].item()), abs=1e-4)
    p = torch.nn.Parameter(s["sphere_radius"].clone())
    opt = torch.optim.Adam([p], lr=0.5, betas=(0.9, 0.999), eps=1e-8)
    p.grad = g1["sphere_radius"].clone()
    opt.step()
    assert after["sphere_radius"].item() == pytest.approx(p.item(), abs=1e-6)
