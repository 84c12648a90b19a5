"""Port parity: the tiled hard frame (kernels/fwd_tiled.py render_tiled) —
on the CPU the kernel wrapper runs its plain torch twin — against the JAX
package's render_tiled in Pallas interpret mode, on the same scene arrays.

Bars (those of tests/test_pallas_tiled.py and tests/test_golden.py): int and
packed frames >= 99.5% of pixels identical, float frames within 0.5/255 on
>= 99.5% of pixels, the hard goldens > 99.9% identical.
"""

import os

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as J
import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu.kernels.fwd_tiled import render_tiled as j_render_tiled
from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled as tft
from opencl_ray_tracer_tpu_torch.kernels.fwd_tiled import render_tiled
from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays, scene_to_arrays
from opencl_ray_tracer_tpu_torch.utils import pack_rgba, read_png, unpack_words

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = torch.device("cpu")
W, H = 256, 128  # 2x2 tiles of 128x64
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _pinhole(w, h):
    return dict(position=(320.0, 240.0, 60.0), look_at=(320.0, 240.0, -85.0),
                fov_degrees=80.0, width=w, height=h)


def _scene(name):
    if name == "scene1":
        js = J.create_scene1()
    elif name == "scene2":
        js = J.create_scene2(seed=7)
    else:
        js = J.random_scene(20, 20, seed=3)
    return js, scene_from_arrays(scene_to_arrays(js), CPU)


def _cameras(kind, w, h):
    if kind == "ortho":
        return J.legacy_ortho_camera(), T.legacy_ortho_camera(device=CPU)
    return J.pinhole_camera(**_pinhole(w, h)), T.pinhole_camera(**_pinhole(w, h), device=CPU)


def _assert_close(got, want, fmt):
    assert got.shape == want.shape
    if fmt == "packed":
        assert got.dtype == np.int32
        same = np.all(unpack_words(got) == unpack_words(want), axis=-1).mean()
        assert same >= 0.995, f"only {same:.4%} identical"
    elif fmt == "int":
        assert got.dtype == np.int32
        same = np.all(got == want, axis=-1).mean()
        assert same >= 0.995, f"only {same:.4%} identical"
    else:
        close = (np.abs(got - want).max(axis=-1) < 0.5).mean()
        assert close >= 0.995, f"only {close:.4%} within 0.5/255"


def _compare(scene_name, cam_kind, shading, shadows, fmt, w=W, h=H):
    js, ts = _scene(scene_name)
    jc, tc = _cameras(cam_kind, w, h)
    kw = dict(width=w, height=h, shading=shading, shadows=shadows,
              framebuffer_dtype=fmt)
    want = np.asarray(j_render_tiled(js, jc, J.RenderConfig(**kw)))
    got = render_tiled(ts, tc, T.RenderConfig(**kw)).numpy()
    _assert_close(got, want, fmt)


@pytest.mark.parametrize(
    "scene_name,cam_kind,shading,shadows,fmt",
    [
        ("scene1", "ortho", "legacy", False, "int"),
        ("scene1", "ortho", "lambert", False, "float"),
        ("scene1", "ortho", "lambert", True, "float"),
        ("scene1", "ortho", "phong", False, "float"),
        ("scene1", "ortho", "phong", True, "float"),
        ("scene1", "ortho", "phong", True, "packed"),
        ("scene2", "ortho", "legacy", False, "packed"),
        ("scene2", "ortho", "phong", True, "float"),
        ("scene1", "pinhole", "legacy", False, "int"),
        ("scene1", "pinhole", "legacy", False, "packed"),
        ("scene1", "pinhole", "lambert", True, "float"),
        ("scene1", "pinhole", "phong", True, "float"),
        ("scene1", "pinhole", "phong", False, "float"),
        ("scene3_small", "ortho", "legacy", False, "int"),
    ],
)
def test_tiled_matches_jax(scene_name, cam_kind, shading, shadows, fmt):
    _compare(scene_name, cam_kind, shading, shadows, fmt)


def test_tiled_non_aligned_resolution():
    _compare("scene1", "ortho", "legacy", False, "int", w=200, h=100)


@pytest.mark.parametrize("n_spheres,n_cubes,seed", [(10, 0, 5), (0, 10, 6)])
def test_tiled_spheres_only_and_tris_only(n_spheres, n_cubes, seed):
    js = J.random_scene(n_spheres, n_cubes, seed=seed, bounds=(250.0, 120.0))
    ts = scene_from_arrays(scene_to_arrays(js), CPU)
    kw = dict(width=W, height=H, shading="phong", shadows=True,
              framebuffer_dtype="float")
    want = np.asarray(j_render_tiled(js, J.legacy_ortho_camera(), J.RenderConfig(**kw)))
    got = render_tiled(ts, T.legacy_ortho_camera(device=CPU), T.RenderConfig(**kw))
    _assert_close(got.numpy(), want, "float")


def test_tiled_overflow_escalates_k():
    """40 spheres piled on one spot overflow every tile they cover at the
    default K: the port re-bins with a larger K (no brute fallback) and
    still matches the JAX frame."""
    js = J.random_scene(40, 0, seed=9, bounds=(60.0, 40.0))
    ts = scene_from_arrays(scene_to_arrays(js), CPU)
    cfg = T.RenderConfig(width=W, height=H, shading="legacy")
    assert bool(tft.bin_scene(ts.pack(), height=H, width=W, k=cfg.cull_k).overflow)
    assert not bool(tft.bin_scene(ts.pack(), height=H, width=W, k=48).overflow)
    with pytest.raises(ValueError, match="overflow"):
        tft.render_tiled_packed(
            ts.pack(), T.legacy_ortho_camera(device=CPU), cfg,
            bins=tft.bin_scene(ts.pack(), height=H, width=W, k=cfg.cull_k),
        )
    want = np.asarray(j_render_tiled(js, J.legacy_ortho_camera(),
                                     J.RenderConfig(width=W, height=H)))
    got = render_tiled(ts, T.legacy_ortho_camera(device=CPU), cfg).numpy()
    _assert_close(got, want, "int")


@pytest.mark.parametrize(
    "name,shading,shadows,cam_kind",
    [
        ("pallas_scene1_legacy", "legacy", False, "ortho"),
        ("pallas_scene1_phong", "phong", True, "ortho"),
        ("pallas_scene1_pinhole", "legacy", False, "pinhole"),
        ("pallas_scene1_pinhole_phong", "phong", True, "pinhole"),
    ],
)
def test_hard_golden(name, shading, shadows, cam_kind):
    """The committed tiled-kernel goldens (tests/test_golden.py CASES)."""
    w, h = 160, 120
    _, cam = _cameras(cam_kind, w, h)
    cfg = T.RenderConfig(width=w, height=h, shading=shading, shadows=shadows,
                         framebuffer_dtype="int" if shading == "legacy" else "float")
    got = pack_rgba(render_tiled(T.create_scene1(device=CPU), cam, cfg))
    want = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))
    same = np.all(got == want, axis=-1).mean()
    assert same > 0.999, f"{name}: only {same:.4%} identical to golden"


def test_renderer_facade_and_msaa():
    """models.renderer: backend dispatch, packed on every backend, MSAA."""
    scene = T.create_scene1(device=CPU)
    cfg = T.RenderConfig(width=W, height=H, shading="lambert",
                         framebuffer_dtype="packed")
    tiled = T.render(scene, None, cfg, backend="pallas")
    oracle = T.render(scene, None, cfg, backend="reference")
    assert tiled.shape == oracle.shape == (H, W)
    same = np.all(unpack_words(tiled) == unpack_words(oracle), axis=-1).mean()
    assert same >= 0.995
    ms = T.get_renderer("legacy", width=W, height=H, msaa=4).render(scene)
    assert ms.shape == (H, W, 4) and ms.dtype == torch.int32
    soft = T.get_renderer("soft", width=W, height=H).render(scene)
    assert soft.shape == (H, W, 4) and soft.dtype == torch.float32
    assert torch.isfinite(soft).all() and (soft[..., :3] > 1.0).any()
    xla = T.render(scene, None, cfg, backend="xla")  # packed through float
    assert xla.shape == (H, W) and xla.dtype == torch.int32
    assert torch.equal(xla, oracle)
