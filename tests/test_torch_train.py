"""Port parity for training: perturb_scene, the Adam train step against the
JAX package's (optax.adam through parallel/train.make_train_step on a
1-device mesh), kill-and-resume of fit_scene (on the compiled step, which
the CPU runs eagerly), `load_checkpoint` in place into a stepped state, and
the card-only CLI fit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import opencl_ray_tracer_tpu as J
import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu.models.inverse import perturb_scene as j_perturb
from opencl_ray_tracer_tpu.models.inverse import (
    param_filter_from_names as j_filter,
)
from opencl_ray_tracer_tpu.parallel import (
    init_train_state as j_init,
    make_mesh,
    make_train_step as j_make_step,
    replicate,
    shard_rows,
)
from opencl_ray_tracer_tpu_torch.diff import render_soft
from opencl_ray_tracer_tpu_torch.models.inverse import (
    SPHERE_PARAMS,
    fit_scene,
    param_filter_from_names,
    perturb_scene,
)
from opencl_ray_tracer_tpu_torch.parallel import (
    adam,
    init_train_state,
    make_train_step,
)
from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays, scene_to_arrays

torch.set_num_threads(2)

CPU = torch.device("cpu")
W, H = 256, 128


def test_perturb_scene_bit_identical():
    js = J.create_scene1()
    ts = scene_from_arrays(scene_to_arrays(js), CPU)
    a = j_perturb(js, seed=3)
    b = perturb_scene(ts, seed=3)
    for k in ("sphere_origin", "sphere_radius", "sphere_colour", "tri_verts"):
        assert np.array_equal(np.asarray(getattr(a, k)),
                              getattr(b, k).numpy()), k
    assert b.sphere_colour[:, :3].min() >= 0.05


def test_param_filter_names():
    f = param_filter_from_names(SPHERE_PARAMS)
    assert f("sphere_origin") and not f("tri_verts")
    assert not f("lights.position")
    assert param_filter_from_names(("lights",))("lights.position")


def test_adam_steps_match_optax():
    """3 steps of the port's train step against the JAX package's, both on
    the soft oracle (backend "reference") at 256x128, sphere parameters
    trainable: the scenes stay allclose after every step."""
    js_true = J.random_scene(5, 3, seed=4, bounds=(250.0, 120.0))
    ts_true = scene_from_arrays(scene_to_arrays(js_true), CPU)
    kw = dict(width=W, height=H, shading="lambert", soft=True,
              framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.75,
              backend="reference")
    jcfg, tcfg = J.RenderConfig(**kw), T.RenderConfig(**kw)
    target = render_soft(ts_true, T.legacy_ortho_camera(device=CPU), tcfg)
    js0 = j_perturb(js_true, seed=1)
    ts0 = scene_from_arrays(scene_to_arrays(js0), CPU)
    lr = 0.3

    mesh = make_mesh(1)
    opt = optax.adam(lr)
    jstep = j_make_step(J.legacy_ortho_camera(), jcfg, opt, mesh=mesh,
                        param_filter=j_filter(SPHERE_PARAMS))
    jstate = j_init(replicate(js0, mesh), opt)
    jtarget = shard_rows(jnp.asarray(target.numpy()), mesh)

    topt = adam(lr)
    tstep = make_train_step(T.legacy_ortho_camera(device=CPU), tcfg, topt,
                            param_filter=param_filter_from_names(SPHERE_PARAMS))
    tstate = init_train_state(ts0, topt)
    for i in range(3):
        jstate, jloss = jstep(jstate, jtarget)
        tstate, tloss = tstep(tstate, target)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-4)
        for k in ("sphere_origin", "sphere_radius", "sphere_colour",
                  "tri_verts"):
            np.testing.assert_allclose(
                getattr(tstate.scene, k).detach().numpy(),
                np.asarray(getattr(jstate.scene, k)), rtol=1e-5, atol=1e-3,
                err_msg=f"step {i} {k}")
    assert tstate.step == 3
    assert not np.allclose(tstate.scene.sphere_origin.detach().numpy(),
                           ts0.sphere_origin.numpy())


def test_make_train_step_rejects_mesh_and_msaa():
    """A mesh is taken now (tests/test_torch_parallel.py); one whose ranks do
    not split the height is rejected, and so is msaa."""
    from opencl_ray_tracer_tpu_torch.parallel import IMAGE_AXIS, Mesh

    cfg = T.RenderConfig(width=W, height=H, soft=True, framebuffer_dtype="float")
    cam = T.legacy_ortho_camera(device=CPU)
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(cam, cfg, adam(0.1), mesh=Mesh((3,), (IMAGE_AXIS,)))
    with pytest.raises(ValueError, match="msaa"):
        make_train_step(cam, cfg.replace(msaa=4), adam(0.1))


@pytest.fixture(scope="module")
def problem():
    w, h = 128, 64
    cfg = T.RenderConfig(width=w, height=h, shading="lambert", soft=True,
                         framebuffer_dtype="float", tau_depth=1.0,
                         tau_edge=0.75)
    cam = T.legacy_ortho_camera(device=CPU)
    true_scene = T.Scene.build(
        device=CPU, sphere_origin=[[w * 0.5, h * 0.5, -60.0]],
        sphere_radius=[h * 0.3], sphere_colour=[[1.0, 0.3, 0.2, 255.0]])
    target = render_soft(true_scene, cam, cfg)
    init = T.Scene.build(
        device=CPU, sphere_origin=[[w * 0.6, h * 0.4, -60.0]],
        sphere_radius=[h * 0.22], sphere_colour=[[0.6, 0.5, 0.5, 255.0]])
    return cfg, cam, target, init


def test_fit_resumes_from_checkpoint(problem, tmp_path):
    """Fit 10 steps in one run vs 5 steps (checkpointed), "crash", then the
    remaining 5: the resumed run lands on the uninterrupted one's state. The
    default backend is "pallas": on the CPU, the tiled soft twin."""
    cfg, cam, target, init = problem
    kw = dict(camera=cam, config=cfg, learning_rate=0.3,
              trainable=SPHERE_PARAMS, log_every=100)
    straight, losses = fit_scene(init, target, steps=10, **kw)
    assert losses[-1] < losses[0]
    ckdir = str(tmp_path / "ck")
    fit_scene(init, target, steps=5, checkpoint_dir=ckdir, checkpoint_every=5,
              **kw)
    resumed, _ = fit_scene(init, target, steps=10, checkpoint_dir=ckdir,
                           checkpoint_every=5, **kw)
    for k in ("sphere_origin", "sphere_radius"):
        np.testing.assert_allclose(getattr(resumed, k).numpy(),
                                   getattr(straight, k).numpy(), rtol=0,
                                   atol=1e-5)


def test_fit_resume_past_end_is_noop(problem, tmp_path):
    cfg, cam, target, init = problem
    kw = dict(camera=cam, config=cfg, learning_rate=0.3,
              trainable=SPHERE_PARAMS, log_every=100,
              checkpoint_dir=str(tmp_path / "ck2"), checkpoint_every=3)
    a, _ = fit_scene(init, target, steps=3, **kw)
    b, losses = fit_scene(init, target, steps=3, **kw)
    assert losses == []
    assert torch.equal(a.sphere_origin, b.sphere_origin)
    assert dataclasses.is_dataclass(b)


def _leaf_and_moment_tensors(state):
    from opencl_ray_tracer_tpu_torch.parallel.train import scene_leaves

    leaves = list(scene_leaves(state.scene).values())
    return leaves + [v for p in leaves
                     for v in state.opt_state.state.get(p, {}).values()
                     if isinstance(v, torch.Tensor)]


def test_load_checkpoint_keeps_the_optimizer_tensors(problem, tmp_path):
    """Once the optimizer holds state, `load_checkpoint` copies into its
    tensors in place (a captured step reads them by address): every leaf's
    and every Adam moment's and step count's data_ptr is kept, and the values
    are the checkpoint's. Before the first step it loads as the optimizer's
    own `load_state_dict` does."""
    from opencl_ray_tracer_tpu_torch.parallel.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    cfg, cam, target, init = problem
    opt = adam(0.3)
    step = make_train_step(cam, cfg, opt, jit=True)
    state = init_train_state(init, opt)
    fresh = init_train_state(init, opt)
    state, _ = step(state, target)
    ck = save_checkpoint(str(tmp_path / "ck"), state)
    saved = [t.clone() for t in _leaf_and_moment_tensors(state)]
    assert len(saved) > 10  # leaves, exp_avg, exp_avg_sq, step
    state, _ = step(state, target)
    ptrs = [t.data_ptr() for t in _leaf_and_moment_tensors(state)]
    back = load_checkpoint(ck, state)
    assert back.step == 1
    now = _leaf_and_moment_tensors(back)
    assert [t.data_ptr() for t in now] == ptrs
    for a, b in zip(now, saved):
        assert torch.equal(a, b)
    fresh = load_checkpoint(ck, fresh)  # no optimizer state yet
    for a, b in zip(_leaf_and_moment_tensors(fresh), saved):
        assert torch.equal(a, b)


def test_resume_into_a_stepped_state_continues_the_run(problem, tmp_path):
    """The compiled step (`jit=True`, as fit_scene builds it) keeps one
    state: 6 steps straight, against 2 steps, a resume from the checkpoint
    at step 3 into that same state, and 3 more steps: the same losses and
    scene, bit for bit."""
    from opencl_ray_tracer_tpu_torch.parallel.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from opencl_ray_tracer_tpu_torch.parallel.train import scene_leaves

    cfg, cam, target, init = problem
    opt = adam(0.3)
    step = make_train_step(cam, cfg, opt, jit=True)
    state, straight = init_train_state(init, opt), []
    for i in range(6):
        state, loss = step(state, target)
        straight.append(float(loss))
        if i == 2:
            ck = save_checkpoint(str(tmp_path / "ck"), state)
    other = init_train_state(perturb_scene(init, seed=3), opt)
    for _ in range(2):
        other, _ = step(other, target)
    other = load_checkpoint(ck, other)
    assert other.step == 3
    resumed = []
    for _ in range(3):
        other, loss = step(other, target)
        resumed.append(float(loss))
    assert resumed == straight[3:]
    for k, v in scene_leaves(state.scene).items():
        assert torch.equal(scene_leaves(other.scene)[k], v), k


def test_cli_fit_needs_a_card():
    from opencl_ray_tracer_tpu_torch.cli import main

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["fit", "--scene", "1", "--steps", "2"])
