"""Port parity: the brute hard frame (kernels/fwd.py render_pallas, which on
the CPU runs the brute kernel's plain twin) against the JAX package's
render_pallas in Pallas interpret mode, on the same scene arrays, and
against the port's own oracle and tiled path.

Bars: legacy int frames identical on >= 99.9% of pixels (the goldens' bar;
99.8% on the 100x70 frame, see there); shaded float frames within 0.5/255
on >= 99.9% of pixels; against the oracle the JAX package's own bars
(tests/test_pallas_fwd.py).
"""

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as J
import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu.kernels import render_pallas as j_render_pallas
from opencl_ray_tracer_tpu_torch.kernels import (
    fwd,
    render_pallas,
    render_pallas_packed,
    render_tiled,
)
from opencl_ray_tracer_tpu_torch.ref import render_reference
from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays, scene_to_arrays

torch.set_num_threads(2)

CPU = torch.device("cpu")
W, H = 256, 128
PINHOLE = dict(position=(128.0, 64.0, 60.0), look_at=(128.0, 64.0, -85.0),
               fov_degrees=80.0, width=W, height=H)
JAX_SCENES = {
    "scene1": lambda: J.create_scene(1),
    "scene2": lambda: J.create_scene(2),
    "test": lambda: J.random_scene(5, 3, seed=4, bounds=(250.0, 120.0)),
    "spheres": lambda: J.random_scene(10, 0, seed=5, bounds=(250.0, 120.0)),
    "tris": lambda: J.random_scene(0, 10, seed=6, bounds=(250.0, 120.0)),
}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, make in JAX_SCENES.items():
        js = make()
        out[name] = (js, scene_from_arrays(scene_to_arrays(js), CPU))
    return out


def _cameras(kind, w=W, h=H):
    if kind == "ortho":
        return J.legacy_ortho_camera(), T.legacy_ortho_camera(device=CPU)
    kw = dict(PINHOLE, width=w, height=h)
    return J.pinhole_camera(**kw), T.pinhole_camera(**kw, device=CPU)


def _both(scenes, name, cam_kind, w=W, h=H, **cfg):
    js, ts = scenes[name]
    jc, tc = _cameras(cam_kind, w, h)
    kw = dict(width=w, height=h, **cfg)
    want = np.asarray(j_render_pallas(js, jc, J.RenderConfig(**kw), interpret=True))
    before = fwd.BRUTE_LAUNCHES
    got = render_pallas(ts, tc, T.RenderConfig(**kw))
    assert fwd.BRUTE_LAUNCHES == before  # CPU: the twin, no launch
    return got.numpy(), want


@pytest.mark.parametrize("cam_kind", ["ortho", "pinhole"])
@pytest.mark.parametrize("name", ["scene1", "scene2", "test", "spheres", "tris"])
def test_legacy_int_matches_jax(scenes, name, cam_kind):
    got, want = _both(scenes, name, cam_kind, shading="legacy")
    assert got.shape == want.shape == (H, W, 4) and got.dtype == np.int32
    if cam_kind == "ortho":
        assert (want[..., :3] != 0).any(), "the camera sees nothing"
    frac = (got == want).all(-1).mean()
    assert frac >= 0.999, f"only {frac:.4%} identical"


@pytest.mark.parametrize("cam_kind", ["ortho", "pinhole"])
@pytest.mark.parametrize("shading,shadows", [("lambert", False), ("lambert", True),
                                             ("phong", False), ("phong", True)])
def test_shaded_float_matches_jax(scenes, cam_kind, shading, shadows):
    got, want = _both(scenes, "scene1", cam_kind, shading=shading,
                      shadows=shadows, framebuffer_dtype="float")
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert (want[..., :3] > 1.0).any(), "the camera sees nothing"
    close = (np.abs(got - want).max(-1) < 0.5).mean()
    assert close >= 0.999, f"only {close:.4%} within 0.5/255"


@pytest.mark.parametrize("w,h", [(100, 70), (130, 90)])
def test_non_tile_aligned_resolution(scenes, w, h):
    """100x70 and 130x90: pixel counts that are no multiple of the TPU
    kernel's 512-pixel tile nor of a CUDA block. Most of these small frames
    is lit, so the triangle-seam pixels (u + v == 1 up to float32 rounding,
    where XLA's fused multiply-adds and the twin's unfused ones fall on
    different sides) weigh more than at 256x128: at 100x70 10 of 7000
    differ, 99.857% identical. The bar is 99.8% (the JAX package's own test
    at 100x70 holds its kernel to its oracle at 99.5%,
    tests/test_pallas_fwd.py:87-99)."""
    got, want = _both(scenes, "scene1", "ortho", w=w, h=h, shading="legacy")
    assert got.shape == (h, w, 4)
    frac = (got == want).all(-1).mean()
    assert frac >= 0.998, f"only {frac:.4%} identical"


@pytest.mark.parametrize("cam_kind", ["ortho", "pinhole"])
def test_ragged_width_shaded_matches_jax(scenes, cam_kind):
    """250x123, phong + shadows: a width that is no multiple of the 128
    pixels a warp of the CUDA kernel covers nor of the 4 a thread holds, and
    rows that end inside a warp's span."""
    got, want = _both(scenes, "scene1", cam_kind, w=250, h=123, shading="phong",
                      shadows=True, framebuffer_dtype="float")
    assert got.shape == want.shape == (123, 250, 4) and np.isfinite(got).all()
    assert (want[..., :3] > 1.0).any(), "the camera sees nothing"
    close = (np.abs(got - want).max(-1) < 0.5).mean()
    assert close >= 0.999, f"only {close:.4%} within 0.5/255"


@pytest.mark.parametrize("name,cam_kind,bar", [("scene1", "ortho", 0.999),
                                               ("scene2", "ortho", 0.999),
                                               ("spheres", "ortho", 0.999),
                                               ("tris", "ortho", 0.999),
                                               ("scene1", "pinhole", 0.995)])
def test_legacy_matches_port_oracle(scenes, name, cam_kind, bar):
    _, ts = scenes[name]
    _, tc = _cameras(cam_kind)
    cfg = T.RenderConfig(width=W, height=H, shading="legacy")
    frac = (render_pallas(ts, tc, cfg) == render_reference(ts, tc, cfg)
            ).all(-1).float().mean().item()
    assert frac > bar, f"only {frac:.4%} identical"


@pytest.mark.parametrize("cam_kind", ["ortho", "pinhole"])
@pytest.mark.parametrize("shading,shadows,fb", [("legacy", False, "int"),
                                                ("phong", True, "float")])
def test_brute_matches_tiled(scenes, cam_kind, shading, shadows, fb):
    """The port's brute and tiled paths (both twins here) render the same
    frame: within 0.5/255 on >= 99.9% of pixels."""
    _, ts = scenes["scene1"]
    _, tc = _cameras(cam_kind)
    cfg = T.RenderConfig(width=W, height=H, shading=shading, shadows=shadows,
                         framebuffer_dtype=fb)
    a = render_pallas_packed(ts.pack(), tc, cfg).float()
    b = render_tiled(ts, tc, cfg).float()
    assert ((a - b).abs().amax(-1) < 0.5).float().mean().item() >= 0.999


def test_packed_words_are_refused(scenes):
    _, ts = scenes["scene1"]
    cfg = T.RenderConfig(width=W, height=H, framebuffer_dtype="packed")
    with pytest.raises(ValueError, match="packed"):
        render_pallas(ts, T.legacy_ortho_camera(device=CPU), cfg)
