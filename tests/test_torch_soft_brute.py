"""Port parity: the brute soft path (kernels/soft.py `_soft_render_core`,
which on the CPU runs the brute soft kernels' plain twin and its autograd)
against the JAX package's `_soft_render_core` in Pallas interpret mode, on
the same scene arrays; and against the port's own tiled soft path.

Bars: operands allclose (rtol 1e-6); images within 0.05/255 on every pixel;
gradients of every packed leaf, the lights and both temperatures, normalised
by the JAX gradient's largest magnitude, within 1e-3; padded primitives get
finite, exactly zero gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as J
import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu.kernels import soft as jsoft
from opencl_ray_tracer_tpu_torch.kernels import soft as S
from opencl_ray_tracer_tpu_torch.kernels.soft_tiled import render_soft_tiled
from opencl_ray_tracer_tpu_torch.parallel.train import scene_leaves, trainable_scene
from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays, scene_to_arrays
from opencl_ray_tracer_tpu_torch.utils import tracing

torch.set_num_threads(2)

CPU = torch.device("cpu")
W, H = 256, 128
PINHOLE = dict(position=(128.0, 64.0, 200.0), look_at=(128.0, 64.0, -60.0),
               fov_degrees=65.0, width=W, height=H)
MODES = [("legacy", False), ("lambert", False), ("lambert", True),
         ("phong", True)]
PACKED_LEAVES = ("sph_origin", "sph_radius", "sph_colour", "tri_v0", "tri_e1",
                 "tri_e2", "tri_colour")
LIGHT_LEAVES = ("position", "colour", "intensity", "ambient", "spec_strength",
                "shininess")


@pytest.fixture(scope="module")
def scenes():
    js = J.random_scene(5, 3, seed=4, bounds=(250.0, 120.0))
    return js, scene_from_arrays(scene_to_arrays(js), CPU)


def _cameras(kind):
    if kind == "ortho":
        return J.legacy_ortho_camera(), T.legacy_ortho_camera(device=CPU)
    return J.pinhole_camera(**PINHOLE), T.pinhole_camera(**PINHOLE, device=CPU)


def _jax_core(packed, cam, td, te, shading, shadows, normalize_dir):
    return jsoft._soft_render_core(packed, cam, td, te, H, W, shading, shadows,
                                   normalize_dir, True)


def test_prep_soft_arrays_match_jax(scenes):
    js, ts = scenes
    want = jsoft._prep_soft_arrays(js.pack())
    got = S._prep_soft_arrays(ts.pack())
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cam_kind", ["ortho", "pinhole"])
@pytest.mark.parametrize("shading,shadows", MODES)
def test_soft_render_core_matches_jax(scenes, cam_kind, shading, shadows):
    js, ts = scenes
    jc, tc = _cameras(cam_kind)
    nd = cam_kind == "pinhole"
    want = np.asarray(_jax_core(js.pack(), jc, jnp.float32(1.0),
                                jnp.float32(0.5), shading, shadows, nd))
    before = (tracing.counter("launch.B6"), tracing.counter("launch.B7"))
    got = S._soft_render_core(ts.pack(), tc, 1.0, 0.5, H, W, shading, shadows, nd)
    assert (tracing.counter("launch.B6"), tracing.counter("launch.B7")) == before
    got = got.numpy()
    assert got.shape == want.shape == (H, W, 4) and np.isfinite(got).all()
    if shading != "legacy":
        assert (want[..., :3] > 1.0).any(), "the camera sees nothing"
    err = np.abs(got - want).max()
    assert err < 0.05, f"max error {err}"


def _torch_grads(ts, tc, shading, shadows, nd):
    p = ts.pack()
    leaves = [getattr(p, n).detach().clone().requires_grad_(True)
              for n in PACKED_LEAVES]
    lleaves = [getattr(p.lights, n).detach().clone().requires_grad_(True)
               for n in LIGHT_LEAVES]
    lights = dataclasses.replace(p.lights, **dict(zip(LIGHT_LEAVES, lleaves)))
    p = dataclasses.replace(p, lights=lights, **dict(zip(PACKED_LEAVES, leaves)))
    taus = [torch.tensor(1.0, requires_grad=True),
            torch.tensor(0.5, requires_grad=True)]
    img = S._soft_render_core(p, tc, taus[0], taus[1], H, W, shading, shadows, nd)
    grads = torch.autograd.grad(torch.mean(img[..., :3] ** 2),
                                leaves + lleaves + taus, allow_unused=True)
    return [np.zeros(tuple(v.shape), np.float32) if g is None else g.numpy()
            for v, g in zip(leaves + lleaves + taus, grads)]


@pytest.mark.parametrize("cam_kind,shading,shadows",
                         [("ortho", "phong", True), ("pinhole", "lambert", False)])
def test_soft_render_core_grads_match_jax(scenes, cam_kind, shading, shadows):
    """SoftBruteFunction's backward (autograd of the twin, then of the prep)
    against jax.grad through the JAX custom_vjp (its fused backward kernel
    in interpret mode): every packed leaf, the lights, both temperatures."""
    js, ts = scenes
    jc, tc = _cameras(cam_kind)
    nd = cam_kind == "pinhole"

    def loss(p, td, te):
        return jnp.mean(_jax_core(p, jc, td, te, shading, shadows, nd)[..., :3] ** 2)

    gp, gtd, gte = jax.grad(loss, argnums=(0, 1, 2))(
        js.pack(), jnp.float32(1.0), jnp.float32(0.5))
    want = ([np.asarray(getattr(gp, n)) for n in PACKED_LEAVES]
            + [np.asarray(getattr(gp.lights, n)) for n in LIGHT_LEAVES]
            + [np.asarray(gtd), np.asarray(gte)])
    got = _torch_grads(ts, tc, shading, shadows, nd)
    names = PACKED_LEAVES + tuple(f"lights.{n}" for n in LIGHT_LEAVES) + (
        "tau_depth", "tau_edge")
    n_real = {"sph": js.num_spheres, "tri": js.num_triangles}
    for name, a, b in zip(names, got, want):
        assert np.all(np.isfinite(a)), name
        scale = np.abs(b).max()
        if scale == 0.0:  # e.g. the specular leaves under lambert
            assert np.abs(a).max() == 0.0, name
            continue
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-3, err_msg=name)
        if name[:3] in n_real:  # padded lanes: exactly zero
            assert np.abs(a[..., n_real[name[:3]]:]).max() == 0.0, name
    assert np.any(got[7] != 0), "no light-position gradient"
    assert got[-1] != 0 and got[-2] != 0


def _scene_grads(render, scene, cam, cfg):
    s = trainable_scene(scene)
    leaves = scene_leaves(s)
    loss = torch.mean(render(s, cam, cfg)[..., :3] ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), grads)}


def _brute(scene, cam, cfg):
    return S._soft_render_core(scene.pack(), cam, cfg.tau_depth, cfg.tau_edge,
                               cfg.height, cfg.width, cfg.shading, cfg.shadows,
                               cam.normalize)


@pytest.mark.parametrize("shading,shadows", MODES)
def test_brute_matches_tiled_image(scenes, shading, shadows):
    """The port's brute and tiled soft paths on a scene where the tiled
    path culls nothing that matters: image within 0.05/255."""
    _, ts = scenes
    cam = T.legacy_ortho_camera(device=CPU)
    cfg = T.RenderConfig(width=W, height=H, shading=shading, shadows=shadows,
                         soft=True, framebuffer_dtype="float", tau_depth=1.0,
                         tau_edge=0.5)
    with torch.no_grad():
        err = (_brute(ts, cam, cfg) - render_soft_tiled(ts, cam, cfg)).abs().max()
    assert err.item() < 0.05


def test_brute_matches_tiled_grads(scenes):
    """... and every scene leaf's gradient within 1e-3 of the tiled path's,
    normalised by its largest (phong + soft shadows)."""
    _, ts = scenes
    cam = T.legacy_ortho_camera(device=CPU)
    cfg = T.RenderConfig(width=W, height=H, shading="phong", shadows=True,
                         soft=True, framebuffer_dtype="float", tau_depth=1.0,
                         tau_edge=0.5)
    gb = _scene_grads(_brute, ts, cam, cfg)
    gt = _scene_grads(render_soft_tiled, ts, cam, cfg)
    for k, w in gt.items():
        scale = w.abs().max().item()
        assert torch.isfinite(gb[k]).all(), k
        assert (gb[k] - w).abs().max().item() <= 1e-3 * scale + 1e-12, k


@pytest.mark.parametrize("n_tris,n_spheres,within_old_limit,shading,shadows",
                         [(1200, 1200, True, "legacy", False),
                          (2400, 0, True, "lambert", False),
                          (1200, 1201, False, "lambert", True),
                          (0, 2401, False, "phong", False)],
                         ids=["1200-1200-True", "2400-0-True", "1200-1201-False",
                              "0-2401-False"])
def test_backward_primitive_limit(n_tris, n_spheres, within_old_limit, shading,
                                  shadows):
    """The backward takes any number of primitives (its CUDA kernel once held
    at most 2,400 in shared memory): at and above that count, on a 6x3
    frame, `soft_brute_bwd` passes the wrappers' checks and its gradients of
    all six operands agree with the JAX backward kernel's
    (`_soft_pallas_bwd_arrays` in interpret mode) on the same arrays within
    1e-3 of each operand's largest, finite and with exact zeros in the
    padded columns. (One case walks the occluders: the JAX kernel takes
    about a minute to trace at this primitive count with soft shadows.)"""
    rng = np.random.default_rng(n_tris + 7 * n_spheres)
    h, w = 3, 6
    tp, sp = -(-max(n_tris, 1) // 128) * 128, -(-max(n_spheres, 1) // 128) * 128
    v0 = rng.uniform([-2, -2, -40], [8, 5, -20], (n_tris, 3))
    e1, e2 = rng.uniform(-3, 3, (2, n_tris, 3))
    tris = np.zeros((9, tp), np.float32)
    tris[:, :n_tris] = np.concatenate([v0, e1, e2], axis=1).T
    sph = np.zeros((4, sp), np.float32)
    sph[2, n_spheres:] = 1e9  # padded spheres: far away, radius 0
    sph[:, :n_spheres] = np.concatenate(
        [rng.uniform([-2, -2, -40], [8, 5, -20], (n_spheres, 3)),
         rng.uniform(0.5, 2.0, (n_spheres, 1))], axis=1).T
    colours = rng.uniform(0.1, 1.0, (2, 4, max(tp, sp))).astype(np.float32)
    base = scene_from_arrays(scene_to_arrays(J.random_scene(1, 1, seed=0)), CPU).pack()
    packed = dataclasses.replace(
        base, tri_v0=torch.tensor(tris[0:3]), tri_e1=torch.tensor(tris[3:6]),
        tri_e2=torch.tensor(tris[6:9]), tri_colour=torch.tensor(colours[0][:, :tp]),
        sph_origin=torch.tensor(sph[0:3]), sph_radius=torch.tensor(sph[3:4]),
        sph_colour=torch.tensor(colours[1][:, :sp]), n_tris=n_tris,
        n_spheres=n_spheres)
    assert (n_tris + n_spheres <= 2400) == within_old_limit
    cam = T.legacy_ortho_camera(device=CPU)
    inputs = [S._camera_params(cam, packed.lights), torch.tensor([1.0, 0.5]),
              *S._prep_soft_arrays(packed)]
    cfg = S._static_cfg(packed, shading, shadows, False)
    S._check_brute(*inputs, h, w, cfg)
    g = rng.normal(size=(h, w, 4)).astype(np.float32)
    got = S.soft_brute_bwd(*inputs, torch.tensor(g), height=h, width=w, cfg=cfg)

    pix = jsoft.BWD_TILE_PIXELS
    g8 = np.zeros((8, pix), np.float32)
    g8[0:4, :h * w] = g.reshape(h * w, 4).T
    jcfg = dict(n_tri_chunks=tp // jsoft.CK if n_tris else 0,
                n_sph_chunks=sp // jsoft.CK if n_spheres else 0,
                n_lights=cfg["n_lights"], shading=shading, shadows=shadows,
                normalize_dir=False, tp=pix)
    d_tri_geo, d_tri_alb, d_sph_geo, d_sph_alb, d_par, d_taus = (
        jsoft._soft_pallas_bwd_arrays(
            *(jnp.asarray(t.numpy()) for t in inputs), jnp.asarray(g8), width=w,
            cfg=jcfg, interpret=True))
    want = (np.asarray(d_par)[0], np.asarray(d_taus)[0], d_tri_geo, d_tri_alb,
            d_sph_geo, d_sph_alb)
    for name, a, b, t in zip(("params", "taus", "tri_geo", "tri_alb", "sph_geo",
                              "sph_alb"), got, want, inputs):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape == tuple(t.shape) and np.isfinite(a).all(), name
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-3 * scale, (name, scale)
    assert got[0].abs().max() > 0 and got[1].abs().min() > 0
    assert got[2].abs().max() > 0 or n_tris == 0
    assert got[4].abs().max() > 0 or n_spheres == 0
    assert got[2][:, n_tris:].abs().max() == 0 and got[4][:, n_spheres:].abs().max() == 0


@pytest.mark.parametrize("h,w,ph,pw", [(8, 16, 4, 8), (13, 21, 4, 8), (5, 70, 1, 32)])
def test_live_patches_match_numpy(h, w, ph, pw):
    """`_live_patches` (the plain version of the list the CUDA backward
    walks) against a numpy loop over the patches: a patch is live when any
    colour channel of any of its pixels inside the frame is non-zero; alpha
    does not count."""
    rng = np.random.default_rng(h * 100 + w)
    g = np.zeros((h, w, 4), np.float32)
    ys, xs = rng.integers(0, h, 5), rng.integers(0, w, 5)
    g[ys, xs, rng.integers(0, 3, 5)] = rng.normal(size=5).astype(np.float32)
    g[h - 1, w - 1, 2] = -0.0  # a negative zero is a zero
    g[0, :, 3] = 1.0           # alpha everywhere on the first row
    npy, npx = -(-h // ph), -(-w // pw)
    want = [py * npx + px for py in range(npy) for px in range(npx)
            if (g[py * ph:(py + 1) * ph, px * pw:(px + 1) * pw, :3] != 0).any()]
    got = S._live_patches(torch.tensor(g), ph, pw)
    assert got.dtype == torch.int64 and got.tolist() == want and want
    assert S._live_patches(torch.zeros((h, w, 4)), ph, pw).numel() == 0
    assert S._live_patches(torch.ones((h, w, 4)), ph, pw).tolist() == list(range(npy * npx))
