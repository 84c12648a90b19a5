"""Port parity: the whole-frame xla backend (models/xla_backend.py) against
the JAX package's `render_xla`, and the renderer facade's xla route.

Bars: int frames identical on >= 99.9% of pixels (the goldens' bar), packed
words likewise, float frames within 0.5/255 on every pixel.
"""

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as J
import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu.models.xla_backend import render_xla as j_render_xla
from opencl_ray_tracer_tpu_torch.models.xla_backend import render_xla
from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays, scene_to_arrays

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _pair(num, cam, w, h):
    js = J.create_scene1() if num == 1 else J.create_scene2(seed=7)
    ts = scene_from_arrays(scene_to_arrays(js), CPU)
    if cam == "ortho":
        return js, ts, J.legacy_ortho_camera(), T.legacy_ortho_camera(device=CPU)
    pin = dict(position=(320.0, 240.0, 60.0), look_at=(320.0, 240.0, -85.0),
               fov_degrees=80.0, width=w, height=h)
    return js, ts, J.pinhole_camera(**pin), T.pinhole_camera(**pin, device=CPU)


def _assert_same(got, want, fmt):
    if fmt == "float":
        err = np.abs(got - want).max()
        assert err < 0.5, f"float error {err} >= 0.5/255"
        return
    same = (got == want).all(-1).mean() if fmt == "int" else (got == want).mean()
    assert same >= 0.999, f"only {same:.4%} identical"


# 160x120 is traced at once (120 is no multiple of the 32-row chunk), as is
# 100x70; 160x128 walks four chunks of 32 rows.
@pytest.mark.parametrize("num,cam,shading,shadows,w,h", [
    (num, cam, shading, shadows, 160, 120)
    for num in (1, 2) for cam in ("ortho", "pinhole")
    for shading, shadows in (("legacy", False), ("lambert", True), ("phong", True))
] + [(1, "ortho", "legacy", False, 100, 70),
     (2, "pinhole", "phong", True, 160, 128)])
def test_render_xla_matches_jax(num, cam, shading, shadows, w, h):
    js, ts, jc, tc = _pair(num, cam, w, h)
    for fmt in ("int", "float", "packed"):
        kw = dict(width=w, height=h, shading=shading, shadows=shadows,
                  framebuffer_dtype=fmt)
        if fmt == "packed":  # the facade: float frame, then the words
            want = np.asarray(J.render(js, jc, J.RenderConfig(**kw), backend="xla"))
            got = T.render(ts, tc, T.RenderConfig(**kw), backend="xla")
            assert got.shape == (h, w) and got.dtype == torch.int32
        else:
            want = np.asarray(j_render_xla(js, jc, J.RenderConfig(**kw)))
            got = render_xla(ts, tc, T.RenderConfig(**kw))
            assert got.shape == (h, w, 4)
            assert got.dtype == (torch.int32 if fmt == "int" else torch.float32)
        _assert_same(got.numpy(), want, fmt)


def test_render_xla_chunks_equal_whole_frame():
    """The row-chunked walk and the whole frame at once give the same
    frame."""
    scene = T.create_scene(2, seed=0, device=CPU)
    cam = T.legacy_ortho_camera(device=CPU)
    cfg = T.RenderConfig(width=96, height=64, shading="phong", shadows=True,
                         framebuffer_dtype="float")
    assert torch.equal(render_xla(scene, cam, cfg, row_chunk=16),
                       render_xla(scene, cam, cfg, row_chunk=64))


def test_render_xla_msaa_matches_jax_facade():
    js, ts, jc, tc = _pair(1, "ortho", 160, 120)
    kw = dict(width=160, height=120, shading="legacy", backend="xla", msaa=4)
    want = np.asarray(J.render(js, jc, J.RenderConfig(**kw)))
    got = T.render(ts, tc, T.RenderConfig(**kw)).numpy()
    assert got.shape == (120, 160, 4) and got.dtype == np.int32
    _assert_same(got, want, "int")
