"""Port parity: the soft differentiable oracle (diff/soft.py render_soft,
torch autograd) against the JAX package's diff/soft.py render_soft and
jax.grad, on the same scene arrays.

Bars: images within 0.05/255 on every pixel; gradients of every scene leaf,
normalised by the JAX gradient's largest magnitude, within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as J
import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu.diff import render_soft as j_render_soft
from opencl_ray_tracer_tpu_torch.diff import render_soft
from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays, scene_to_arrays

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

CPU = torch.device("cpu")
W, H = 256, 128
# the test scene's pinhole (tests/test_soft_tiled.py:129-135) and, for
# scene 1 in its 640x480 world box, the hard path's (test_torch_fwd_tiled.py)
PINHOLE = {
    "test": dict(position=(128.0, 64.0, 200.0), look_at=(128.0, 64.0, -60.0),
                 fov_degrees=65.0, width=W, height=H),
    "scene1": dict(position=(320.0, 240.0, 60.0), look_at=(320.0, 240.0, -85.0),
                   fov_degrees=80.0, width=W, height=H),
}
MODES = [("legacy", False), ("lambert", False), ("lambert", True),
         ("phong", True)]
LEAVES = ("sphere_origin", "sphere_radius", "sphere_colour", "tri_verts",
          "tri_colour")
LIGHT_LEAVES = ("position", "colour", "intensity", "ambient", "spec_strength",
                "shininess")


def _scenes(name):
    js = (J.create_scene1() if name == "scene1"
          else J.random_scene(5, 3, seed=4, bounds=(250.0, 120.0)))
    return js, scene_from_arrays(scene_to_arrays(js), CPU)


def _cameras(kind, scene_name):
    if kind == "ortho":
        return J.legacy_ortho_camera(), T.legacy_ortho_camera(device=CPU)
    ph = PINHOLE[scene_name]
    return J.pinhole_camera(**ph), T.pinhole_camera(**ph, device=CPU)


def _cfgs(shading, shadows):
    kw = dict(width=W, height=H, shading=shading, shadows=shadows, soft=True,
              framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.5)
    return J.RenderConfig(**kw), T.RenderConfig(**kw)


@pytest.mark.parametrize("scene_name", ["scene1", "test"])
@pytest.mark.parametrize("cam_kind", ["ortho", "pinhole"])
@pytest.mark.parametrize("shading,shadows", MODES)
def test_render_soft_matches_jax(scene_name, cam_kind, shading, shadows):
    js, ts = _scenes(scene_name)
    jc, tc = _cameras(cam_kind, scene_name)
    jcfg, tcfg = _cfgs(shading, shadows)
    want = np.asarray(j_render_soft(js, jc, jcfg))
    got = render_soft(ts, tc, tcfg).numpy()
    assert got.shape == want.shape == (H, W, 4)
    if shading != "legacy":  # legacy fog is black past t = 180
        assert (want[..., :3] > 1.0).any(), "the camera sees nothing"
    err = np.abs(got - want).max()
    assert err < 0.05, f"max error {err}"


def _torch_grads(ts, tc, tcfg):
    leaves = [getattr(ts, k) for k in LEAVES] + [
        getattr(ts.lights, k) for k in LIGHT_LEAVES]
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = torch.mean(render_soft(ts, tc, tcfg)[..., :3] ** 2)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [np.zeros(tuple(leaf.shape), np.float32) if g is None else g.numpy()
            for leaf, g in zip(leaves, grads)]


@pytest.mark.parametrize(
    "scene_name,cam_kind,shading,shadows",
    [("scene1", "pinhole", "phong", True), ("test", "ortho", "lambert", True)],
)
def test_render_soft_grads_match_jax(scene_name, cam_kind, shading, shadows):
    js, ts = _scenes(scene_name)
    jc, tc = _cameras(cam_kind, scene_name)
    jcfg, tcfg = _cfgs(shading, shadows)
    gj = jax.grad(
        lambda s: jnp.mean(j_render_soft(s, jc, jcfg)[..., :3] ** 2))(js)
    want = [np.asarray(getattr(gj, k)) for k in LEAVES] + [
        np.asarray(getattr(gj.lights, k)) for k in LIGHT_LEAVES]
    got = _torch_grads(ts, tc, tcfg)
    names = LEAVES + tuple(f"lights.{k}" for k in LIGHT_LEAVES)
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        assert np.all(np.isfinite(a)), name
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-3,
                                   err_msg=name)
    assert np.any(got[0] != 0) and np.any(got[3] != 0)
