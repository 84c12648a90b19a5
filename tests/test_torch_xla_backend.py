"""Port parity: the whole-frame xla backend (models/xla_backend.py) against
the JAX package's `render_xla`, the renderer facade's xla route, and the
compiled forms: `render_xla_jit` against JAX's, and the `jit=True` train
step on backend "xla" against JAX's step on that backend.

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


# ---- the compiled forms (render_xla_jit; the jit=True step on "xla") -------


@pytest.mark.parametrize("as_int,shading,shadows,cam,h", [
    (True, "legacy", False, "ortho", 128), (False, "phong", True, "pinhole", 128),
    (True, "lambert", True, "ortho", 70)])
def test_render_xla_jit_matches_jax(as_int, shading, shadows, cam, h):
    """`render_xla_jit` with the JAX function's call shape against JAX's
    `render_xla_jit` (the bars above) and against the eager `render_xla`
    (identical: the same function, which the CPU runs eagerly)."""
    from opencl_ray_tracer_tpu.models.xla_backend import render_xla_jit as j_jit
    from opencl_ray_tracer_tpu_torch.models.xla_backend import render_xla_jit

    w = 160
    js, ts, jc, tc = _pair(2, cam, w, h)
    kw = dict(height=h, width=w, shading=shading, shadows=shadows, as_int=as_int)
    got = render_xla_jit(ts, tc, **kw).numpy()
    want = np.asarray(j_jit(js, jc, **kw))
    assert got.dtype == (np.int32 if as_int else np.float32)
    _assert_same(got, want, "int" if as_int else "float")
    cfg = T.RenderConfig(width=w, height=h, shading=shading, shadows=shadows,
                         framebuffer_dtype="int" if as_int else "float")
    np.testing.assert_array_equal(got, render_xla(ts, tc, cfg).numpy())


def test_jit_train_step_on_xla_matches_jax():
    """`make_train_step(jit=True)` on backend "xla" (the torch-autograd
    oracle at fixed temperatures, as JAX's step renders through
    `render_soft_jit`) against JAX's `make_train_step` on backend "xla" on
    a one-device mesh: 2 Adam steps, losses and every scene leaf within rtol
    1e-5, atol 1e-5 (tests/test_torch_distributed.py's bars)."""
    import jax.numpy as jnp
    import optax

    from opencl_ray_tracer_tpu.parallel import init_train_state as j_init
    from opencl_ray_tracer_tpu.parallel import make_mesh as j_make_mesh
    from opencl_ray_tracer_tpu.parallel import make_train_step as j_make_step
    from opencl_ray_tracer_tpu_torch.parallel import (
        adam,
        init_train_state,
        make_train_step,
    )

    w, h = 128, 64
    kw = dict(width=w, height=h, shading="lambert", shadows=True, soft=True,
              framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.5,
              backend="xla")
    js = J.random_scene(4, 2, seed=5, bounds=(float(w), float(h)))
    ts = scene_from_arrays(scene_to_arrays(js), CPU)
    target = np.random.default_rng(3).uniform(0, 255, (h, w, 4)).astype(np.float32)
    jstep = j_make_step(J.legacy_ortho_camera(), J.RenderConfig(**kw),
                        optax.adam(0.1), mesh=j_make_mesh(1))
    jstate = j_init(js, optax.adam(0.1))
    opt = adam(0.1)
    step = make_train_step(T.legacy_ortho_camera(device=CPU), T.RenderConfig(**kw),
                           opt, jit=True)
    state = init_train_state(ts, opt)
    for i in range(2):
        jstate, jloss = jstep(jstate, jnp.asarray(target))
        state, loss = step(state, torch.from_numpy(target))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        want = scene_to_arrays(jstate.scene)
        for k, v in scene_to_arrays(state.scene).items():
            np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i} {k}")
