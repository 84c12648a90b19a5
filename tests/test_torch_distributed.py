"""The row-sharded train step over several processes: gloo ranks on this
host's CPU, started by `parallel.dryrun` (the port's counterpart of
`__graft_entry__.dryrun_multichip`, which also runs saved problems as
ranks). Two ranks on a flat mesh and four on a flat and a (2, 2) (hosts,
chips) mesh — the two-level all-reduce across the process boundary, which
the JAX tests never ran (tests/distributed_worker.py builds a flat mesh).

Held: the loss and the post-step scene identical across ranks (==); equal
to the JAX package's sharded step on the same mesh shape and to the port's
one-device step within rtol 1e-5; the compiled step (`jit=True`, 2 ranks
flat and 4 on (2, 2), backends "pallas" and "xla") equal to the eager mesh
step and to JAX's sharded step; the whole frame assembled by gather_rows;
fit_scene over two ranks writing each checkpoint once and resuming from it;
no rank importing JAX. The launches run in module fixtures, one process
group each, with a timeout (tiny frames, one thread a rank).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import opencl_ray_tracer_tpu as J
import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu.diff.soft import render_soft_jit
from opencl_ray_tracer_tpu.parallel import init_train_state as j_init
from opencl_ray_tracer_tpu.parallel import make_mesh as j_make_mesh
from opencl_ray_tracer_tpu.parallel import make_mesh_2d as j_make_mesh_2d
from opencl_ray_tracer_tpu.parallel import make_train_step as j_make_step
from opencl_ray_tracer_tpu.parallel import replicate as j_replicate
from opencl_ray_tracer_tpu.parallel import shard_rows as j_shard_rows
from opencl_ray_tracer_tpu_torch.models.inverse import SPHERE_PARAMS
from opencl_ray_tracer_tpu_torch.parallel import adam, init_train_state, make_train_step
from opencl_ray_tracer_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
    run_ranks,
    save_problem,
)
from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays, scene_to_arrays

torch.set_num_threads(2)

CPU = torch.device("cpu")
W, H = 128, 64
LR = 0.1
KEYS = ("sphere_origin", "sphere_radius", "sphere_colour", "tri_verts",
        "tri_colour", "lights.position")
TIMEOUT = 240


def _config(backend, mesh_shape, **kw):
    return dict(width=W, height=H, shading="lambert", soft=True,
                framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.5,
                backend=backend, mesh_shape=mesh_shape, **kw)


@pytest.fixture(scope="module")
def problem():
    """The JAX distributed test's problem: random_scene(4, 2) fitted to the
    soft frame of another random scene."""
    scene = J.random_scene(4, 2, seed=5, bounds=(float(W), float(H)))
    other = J.random_scene(4, 2, seed=6, bounds=(float(W), float(H)))
    target = np.asarray(render_soft_jit(
        other, J.legacy_ortho_camera(), jnp.float32(1.0), jnp.float32(0.5),
        height=H, width=W, shading="lambert"))
    return scene, scene_to_arrays(scene), target


def _load(stem, n):
    out = []
    for r in range(n):
        with np.load(f"{stem}.rank{r}.npz") as d:
            out.append({k: d[k] for k in d.files})
    return out


def _run(tmp, n, problems):
    """problems: name -> save_problem keywords; one launch of n ranks."""
    paths = []
    for name, kw in problems.items():
        paths.append(str(tmp / name))
        save_problem(paths[-1], **kw)
    run_ranks(n, ["--problem", *paths], timeout=TIMEOUT)
    return {name: _load(p, n) for name, p in zip(problems, paths)}


@pytest.fixture(scope="module")
def two_ranks(problem, tmp_path_factory):
    _, arrays, target = problem
    tmp = tmp_path_factory.mktemp("two_ranks")
    ck = str(tmp / "ck")
    fit = dict(learning_rate=0.3, trainable=list(SPHERE_PARAMS), log_every=1,
               checkpoint_every=2)
    base = dict(scene_arrays=arrays, target=target)
    out = _run(tmp, 2, {
        "flat_ref": dict(base, config=T.RenderConfig(**_config("reference", (2,))),
                         steps=3, learning_rate=LR,
                         render=T.RenderConfig(width=W, height=H, shading="phong",
                                               shadows=True, backend="xla",
                                               framebuffer_dtype="float")),
        "flat_pallas": dict(base, config=T.RenderConfig(**_config("pallas", None)),
                            steps=1, learning_rate=LR),
        "flat_pallas3": dict(base, config=T.RenderConfig(**_config("pallas", (2,))),
                             steps=3, learning_rate=LR),
        "flat_pallas_jit": dict(base, config=T.RenderConfig(**_config("pallas", (2,))),
                                steps=3, learning_rate=LR, jit=True),
        "flat_xla_jit": dict(base, config=T.RenderConfig(**_config("xla", (2,))),
                             steps=3, learning_rate=LR, jit=True),
        "fit_a": dict(base, config=T.RenderConfig(**_config("pallas", (2,))),
                      fit=dict(fit, steps=2, checkpoint_dir=ck)),
        "fit_b": dict(base, config=T.RenderConfig(**_config("pallas", (2,))),
                      fit=dict(fit, steps=4, checkpoint_dir=ck)),
        "fit_straight": dict(base, config=T.RenderConfig(**_config("pallas", (2,))),
                             fit=dict(fit, steps=4)),
    })
    out["checkpoints"] = sorted(os.listdir(ck))
    return out


@pytest.fixture(scope="module")
def four_ranks(problem, tmp_path_factory):
    _, arrays, target = problem
    base = dict(scene_arrays=arrays, target=target, steps=2, learning_rate=LR)
    return _run(tmp_path_factory.mktemp("four_ranks"), 4, {
        "flat_ref": dict(base, config=T.RenderConfig(**_config("reference", (4,)))),
        "mesh2d_ref": dict(base, config=T.RenderConfig(**_config("reference", (2, 2))),
                           render=T.RenderConfig(width=W, height=H, shading="legacy",
                                                 framebuffer_dtype="packed")),
        "flat_pallas": dict(base, config=T.RenderConfig(**_config("pallas", (4,)))),
        "mesh2d_pallas": dict(base, config=T.RenderConfig(**_config("pallas", (2, 2)))),
        "mesh2d_pallas_jit": dict(base, config=T.RenderConfig(**_config("pallas", (2, 2))),
                                  steps=3, jit=True),
        "mesh2d_xla_jit": dict(base, config=T.RenderConfig(**_config("xla", (2, 2))),
                               jit=True),
    })


def _assert_ranks_identical(runs):
    for r in runs[1:]:
        assert np.array_equal(r["losses"], runs[0]["losses"])
        for k in KEYS:
            assert np.array_equal(r[f"scene:{k}"], runs[0][f"scene:{k}"]), k


def _jax_run(problem, mesh, steps, backend="reference"):
    scene, _, target = problem
    opt = optax.adam(LR)
    step = j_make_step(J.legacy_ortho_camera(), J.RenderConfig(**_config(backend, None)),
                       opt, mesh=mesh)
    state = j_init(j_replicate(scene, mesh), opt)
    tgt = j_shard_rows(jnp.asarray(target), mesh)
    losses = []
    for _ in range(steps):
        state, loss = step(state, tgt)
        losses.append(float(loss))
    leaves = scene_to_arrays(state.scene)
    return np.asarray(losses), {k: leaves[k] for k in KEYS}


def _port_one_device(problem, steps, backend):
    _, arrays, target = problem
    optimizer = adam(LR)
    step = make_train_step(T.legacy_ortho_camera(device=CPU),
                           T.RenderConfig(**_config(backend, None)), optimizer)
    state = init_train_state(scene_from_arrays(arrays, CPU), optimizer)
    losses = []
    for _ in range(steps):
        state, loss = step(state, torch.tensor(target))
        losses.append(float(loss))
    leaves = scene_to_arrays(state.scene)
    return np.asarray(losses), {k: leaves[k] for k in KEYS}


def _assert_close(run, losses, leaves, atol=1e-6):
    """Losses within rtol 1e-5; every scene leaf within rtol 1e-5 and `atol`
    (1e-5 against the JAX package, as tests/test_distributed.py holds its
    scene: the two soft oracles' gradients differ in the last bits, which
    shows on leaves near zero after a few Adam steps)."""
    np.testing.assert_allclose(run["losses"], losses, rtol=1e-5)
    for k in KEYS:
        np.testing.assert_allclose(run[f"scene:{k}"], leaves[k], rtol=1e-5,
                                   atol=atol, err_msg=k)


def test_two_ranks_identical_across_ranks(two_ranks):
    for name in ("flat_ref", "flat_pallas", "flat_pallas3", "flat_pallas_jit",
                 "flat_xla_jit", "fit_a", "fit_b", "fit_straight"):
        runs = two_ranks[name]
        assert [int(r["rank"]) for r in runs] == [0, 1]
        _assert_ranks_identical(runs)
    assert tuple(two_ranks["flat_pallas"][0]["mesh_shape"]) == (2,)  # None: all


def test_two_ranks_match_jax_mesh_step(problem, two_ranks, eight_devices):
    """3 Adam steps over 2 ranks against the JAX package's step on
    make_mesh(2) (both on their soft oracle)."""
    losses, leaves = _jax_run(problem, j_make_mesh(2), 3)
    _assert_close(two_ranks["flat_ref"][0], losses, leaves, atol=1e-5)


@pytest.mark.parametrize("backend,name,steps", [("reference", "flat_ref", 3),
                                                ("pallas", "flat_pallas", 1)])
def test_two_ranks_match_one_device_step(problem, two_ranks, backend, name, steps):
    """The summed gradients of 2 ranks give the one-device step's scene;
    "pallas" runs the tiled soft twin on each rank's 32-row block."""
    losses, leaves = _port_one_device(problem, steps, backend)
    _assert_close(two_ranks[name][0], losses, leaves)


def _leaves_of(run):
    return {k: run[f"scene:{k}"] for k in KEYS}


def test_two_ranks_jit_step_matches_eager_and_jax(problem, two_ranks, eight_devices):
    """The compiled mesh step (`jit=True`; gloo CPU ranks run it eagerly,
    all-reduce included) over 2 ranks, 3 steps: "pallas" equal to the eager
    mesh step (the same tiled branch: no list overflows) and to the JAX
    package's sharded step on make_mesh(2) through its Pallas kernels in
    interpret mode; "xla" equal to the eager oracle step and to JAX's."""
    jit, eager = two_ranks["flat_pallas_jit"][0], two_ranks["flat_pallas3"][0]
    _assert_close(jit, eager["losses"], _leaves_of(eager))
    losses, leaves = _jax_run(problem, j_make_mesh(2), 3, backend="pallas")
    _assert_close(jit, losses, leaves, atol=1e-5)
    xla, ref = two_ranks["flat_xla_jit"][0], two_ranks["flat_ref"][0]
    _assert_close(xla, ref["losses"], _leaves_of(ref))
    losses, leaves = _jax_run(problem, j_make_mesh(2), 3, backend="xla")
    _assert_close(xla, losses, leaves, atol=1e-5)


def test_gather_rows_two_ranks(problem, two_ranks):
    _, arrays, _ = problem
    cfg = T.RenderConfig(width=W, height=H, shading="phong", shadows=True,
                         backend="xla", framebuffer_dtype="float")
    full = T.render(scene_from_arrays(arrays, CPU), T.legacy_ortho_camera(device=CPU),
                    cfg).numpy()
    for run in two_ranks["flat_ref"]:
        np.testing.assert_array_equal(run["frame"], full)


def test_fit_scene_two_ranks_checkpoints_once_and_resumes(two_ranks):
    """fit_scene(mesh_shape=(2,)): rank 0 writes each checkpoint once (no
    rank's partial file is left), the second call resumes at step 2 (it
    logs steps 2 and 3 only) and lands on the uninterrupted fit's scene."""
    assert two_ranks["checkpoints"] == ["step_00000002.pt", "step_00000004.pt"]
    assert len(two_ranks["fit_a"][0]["losses"]) == 2
    assert len(two_ranks["fit_b"][0]["losses"]) == 2
    np.testing.assert_allclose(two_ranks["fit_b"][0]["losses"],
                               two_ranks["fit_straight"][0]["losses"][2:], rtol=1e-6)
    for k in KEYS:
        np.testing.assert_allclose(two_ranks["fit_b"][0][f"scene:{k}"],
                                   two_ranks["fit_straight"][0][f"scene:{k}"],
                                   rtol=0, atol=1e-5, err_msg=k)
    moved = np.abs(two_ranks["fit_straight"][0]["scene:sphere_origin"]
                   - two_ranks["fit_a"][0]["scene:sphere_origin"]).max()
    assert moved > 0


def test_mesh_2d_across_processes(problem, four_ranks, eight_devices):
    """A (2, 2) mesh over 4 processes: intra-host groups {0, 1} {2, 3}, then
    inter-host {0, 2} {1, 3}. Identical across ranks; equal to the flat
    4-rank run and to the JAX package's make_mesh_2d(2, 2) step. The tiled
    soft twin ("pallas") is held to its own flat 4-rank run: on 16-row
    blocks its frame is not the whole frame's rows (the tiled soft cull
    drops primitives beyond 16 tau_edge of a tile, and a block's tiles are
    its own: on this scene one pixel moves by 65/255, in the JAX package's
    sharded frame as in the port's)."""
    for name in ("flat_ref", "mesh2d_ref", "flat_pallas", "mesh2d_pallas"):
        _assert_ranks_identical(four_ranks[name])
    assert tuple(four_ranks["mesh2d_ref"][0]["mesh_shape"]) == (2, 2)
    flat, mesh2d = four_ranks["flat_ref"][0], four_ranks["mesh2d_ref"][0]
    _assert_close(mesh2d, flat["losses"],
                  {k: flat[f"scene:{k}"] for k in KEYS})
    losses, leaves = _jax_run(problem, j_make_mesh_2d(2, 2), 2)
    _assert_close(mesh2d, losses, leaves, atol=1e-5)
    flat = four_ranks["flat_pallas"][0]
    _assert_close(four_ranks["mesh2d_pallas"][0], flat["losses"],
                  {k: flat[f"scene:{k}"] for k in KEYS})


def test_mesh_2d_jit_step_matches_eager_and_jax(problem, four_ranks, eight_devices):
    """The compiled step on the (2, 2) mesh over 4 processes (the two-level
    all-reduce inside it): identical across ranks; "pallas" equal to the
    eager (2, 2) step over its 2 steps and to the JAX package's
    make_mesh_2d(2, 2) step over 3 (its Pallas kernels in interpret mode);
    "xla" equal to the eager oracle step and to JAX's over 2."""
    for name in ("mesh2d_pallas_jit", "mesh2d_xla_jit"):
        _assert_ranks_identical(four_ranks[name])
    jit, eager = four_ranks["mesh2d_pallas_jit"][0], four_ranks["mesh2d_pallas"][0]
    np.testing.assert_allclose(jit["losses"][:2], eager["losses"], rtol=1e-6)
    losses, leaves = _jax_run(problem, j_make_mesh_2d(2, 2), 3, backend="pallas")
    _assert_close(jit, losses, leaves, atol=1e-5)
    xla, ref = four_ranks["mesh2d_xla_jit"][0], four_ranks["mesh2d_ref"][0]
    _assert_close(xla, ref["losses"], _leaves_of(ref))
    losses, leaves = _jax_run(problem, j_make_mesh_2d(2, 2), 2, backend="xla")
    _assert_close(xla, losses, leaves, atol=1e-5)


def test_gather_rows_mesh_2d(problem, four_ranks):
    _, arrays, _ = problem
    cfg = T.RenderConfig(width=W, height=H, shading="legacy",
                         framebuffer_dtype="packed")
    full = T.render(scene_from_arrays(arrays, CPU), T.legacy_ortho_camera(device=CPU),
                    cfg).numpy()
    for run in four_ranks["mesh2d_ref"]:
        assert run["frame"].shape == (H, W)
        assert (run["frame"] == full).mean() > 0.995


def test_ranks_import_no_jax(two_ranks, four_ranks):
    for runs in list(two_ranks.values()) + list(four_ranks.values()):
        if isinstance(runs, list) and runs and isinstance(runs[0], dict):
            for r in runs:
                assert json.loads(str(r["jax_modules"])) == []


def test_dryrun_multichip_four_ranks(capsys):
    """dryrun_multichip(4) from a process with no group: four gloo ranks,
    the (2, 2) mesh, one step, a finite loss."""
    dryrun_multichip(4)
    out = capsys.readouterr().out
    assert "dryrun_multichip(4): one sharded train step OK" in out
    assert "('host', 'image'), shape (2, 2)" in out
    loss = float(out.rsplit("loss=", 1)[1].split()[0])
    assert np.isfinite(loss) and loss > 0
