"""Port parity: tile binning, shadow tables and the per-frame coefficient
gather (kernels/fwd_tiled.py) against the JAX package's, on the same scene.

Candidate lists, counts and the overflow flag must be exactly equal (they
come from comparisons and a top-k over unique scores); the float tables and
gathered coefficients agree to rtol 1e-5 / atol 1e-4 (sums of products may
round in another order).
"""

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as J
import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu.kernels import fwd as jfwd
from opencl_ray_tracer_tpu.kernels import fwd_tiled as jft
from opencl_ray_tracer_tpu_torch.kernels import fwd as tfwd
from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled as tft
from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays, scene_to_arrays

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = torch.device("cpu")
W, H = 256, 128
PINHOLE = dict(position=(320.0, 240.0, 60.0), look_at=(320.0, 240.0, -85.0),
               fov_degrees=80.0, width=W, height=H)
EXACT = ("t_idx", "t_valid", "s_idx", "s_valid", "counts", "overflow")
STATIC = ("k_tri", "k_sph", "k_sh_tri", "k_sh_sph", "nty", "ntx", "projective")
TABLES = ("tri_attr_t", "sph_attr_t", "tri_sh_t", "sph_sh_t")


def _setup(scene_name, cam_kind):
    js = J.create_scene1() if scene_name == "scene1" else J.random_scene(20, 20, seed=3)
    ts = scene_from_arrays(scene_to_arrays(js), CPU)
    if cam_kind == "ortho":
        jc, tc = J.legacy_ortho_camera(), T.legacy_ortho_camera(device=CPU)
    else:
        jc, tc = J.pinhole_camera(**PINHOLE), T.pinhole_camera(**PINHOLE, device=CPU)
    return js.pack(), ts.pack(), jc, tc


CASES = [(s, c) for s in ("scene1", "scene3_small") for c in ("ortho", "pinhole")]


@pytest.mark.parametrize("scene_name,cam_kind", CASES)
def test_bin_scene_matches_jax(scene_name, cam_kind):
    jp, tp, jc, tc = _setup(scene_name, cam_kind)
    kw = dict(height=H, width=W, k=32, shadows=True, shadow_k=64)
    jb = jft.bin_scene(jp, camera=jc, **kw)
    tb = tft.bin_scene(tp, camera=tc, **kw)
    for f in STATIC:
        assert getattr(tb, f) == getattr(jb, f), f
    for f in EXACT:
        want, got = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert got.shape == want.shape, f
        assert np.array_equal(got.astype(want.dtype), want), f
    for f in TABLES:
        np.testing.assert_allclose(getattr(tb, f).numpy(),
                                   np.asarray(getattr(jb, f)),
                                   rtol=1e-5, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("scene_name,cam_kind", CASES)
def test_gathered_coefs_match_jax(scene_name, cam_kind):
    jp, tp, jc, tc = _setup(scene_name, cam_kind)
    jb = jft.bin_scene(jp, height=H, width=W, k=256, camera=jc)
    tb = tft.bin_scene(tp, height=H, width=W, k=256, camera=tc)
    if cam_kind == "ortho":
        jt, js = jfwd._prep_affine_coefs(jp, jc)
        tt, ts = tfwd._prep_affine_coefs(tp, tc)
        nulls = (jft._NULL_TRI, jft._NULL_SPH)
    else:
        jt, js = jft._prep_projective_coefs(jp, jc)
        tt, ts = tft._prep_projective_coefs(tp, tc)
        nulls = (jft._NULL_TRI_PROJ, jft._NULL_SPH_PROJ)
    for (jcoef, tcoef, idx, valid, null) in (
        (jt, tt, "t_idx", "t_valid", nulls[0]),
        (js, ts, "s_idx", "s_valid", nulls[1]),
    ):
        want = np.asarray(jft._gather_coefs(jcoef, getattr(jb, idx),
                                            getattr(jb, valid), null))
        got = tft._gather_coefs(tcoef, getattr(tb, idx), getattr(tb, valid),
                                null).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("scene_name", ["scene1", "scene3_small"])
def test_scene_arrays_and_params_match_jax(scene_name):
    jp, tp, jc, tc = _setup(scene_name, "pinhole")
    for want, got in zip(jfwd._prep_scene_arrays(jp), tfwd._prep_scene_arrays(tp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    for cam_j, cam_t in ((jc, tc), (J.legacy_ortho_camera(),
                                    T.legacy_ortho_camera(device=CPU))):
        want = np.asarray(jfwd._camera_params(cam_j, jp.lights))
        got = tfwd._camera_params(cam_t, tp.lights).numpy()
        assert got.shape == (21 + 7,) and np.array_equal(got, want)
