"""Port parity for the row-sharded path in one process: shift_camera_rows,
every row block of an 8-way and a 2x4 split through `_render_rows` /
`render_sharded` against the JAX package's `render_sharded` on its virtual
8-device CPU mesh (at the JAX tests' bars: xla identical, the tiled hard
kernel >= 99.5% identical ortho and pinhole, soft within 1e-2, MSAA 4 within
1e-3, packed words >= 99.5%), the compiled blocks of `render_sharded_jit`
against the same JAX frame and the eager blocks, mesh_from_config, and the
train step on a one-rank mesh with the reference's call shape against the
one-device step.
Several ranks over gloo: tests/test_torch_distributed.py.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import opencl_ray_tracer_tpu as J
import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu.parallel import make_mesh as j_make_mesh
from opencl_ray_tracer_tpu.parallel import make_mesh_2d as j_make_mesh_2d
from opencl_ray_tracer_tpu.parallel import render_sharded as j_render_sharded
from opencl_ray_tracer_tpu.parallel import shift_camera_rows as j_shift
from opencl_ray_tracer_tpu_torch.parallel import (
    HOST_AXIS,
    IMAGE_AXIS,
    Mesh,
    adam,
    distributed,
    gather_rows,
    init_train_state,
    make_mesh,
    make_mesh_2d,
    make_train_step,
    mesh_from_config,
    mesh_n_shards,
    mesh_row_axes,
    render_sharded,
    replicate,
    shard_rows,
    shift_camera_rows,
)
from opencl_ray_tracer_tpu_torch.parallel.mesh import _render_rows
from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays, scene_to_arrays

torch.set_num_threads(2)

CPU = torch.device("cpu")
W, H = 128, 64
PINHOLE = dict(position=(64.0, 32.0, 300.0), look_at=(64.0, 32.0, -85.0),
               fov_degrees=60.0, width=W, height=H)


def _cameras(kind):
    if kind == "ortho":
        return J.legacy_ortho_camera(), T.legacy_ortho_camera(device=CPU)
    return J.pinhole_camera(**PINHOLE), T.pinhole_camera(**PINHOLE, device=CPU)


@pytest.fixture(scope="module")
def scenes():
    js = J.create_scene1()
    return js, scene_from_arrays(scene_to_arrays(js), CPU)


@pytest.mark.parametrize("kind", ["ortho", "pinhole"])
@pytest.mark.parametrize("row0", [0, 8, 270, 1079])
def test_shift_camera_rows_matches_jax(kind, row0):
    jc, tc = _cameras(kind)
    a, b = j_shift(jc, row0), shift_camera_rows(tc, row0)
    for f in ("o0", "dox", "doy", "d0", "ddx", "ddy"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), err_msg=f)
    assert b.normalize == a.normalize


def _port_blocks(ts, tc, cfg, split):
    """The frame as the ranks of a `split` mesh render it, one block a rank:
    through render_sharded on each rank's view of the mesh (no process
    group: nothing is communicated), concatenated in rank order."""
    axes = (IMAGE_AXIS,) if len(split) == 1 else (HOST_AXIS, IMAGE_AXIS)
    n = int(np.prod(split))
    blocks = [render_sharded(ts, tc, cfg, mesh=Mesh(split, axes, rank=r))
              for r in range(n)]
    # the same blocks straight through _render_rows and the shifted camera
    hl = cfg.height // n
    direct = _render_rows(ts, shift_camera_rows(tc, (n - 1) * hl), hl,
                          cfg.width, cfg)
    assert torch.equal(direct, blocks[-1])
    return torch.cat(blocks).numpy()


def _agree(got, want, fmt, bar):
    """`bar` "identical"; a float tolerance on every value (below 0.5); or
    the share of pixels that must be identical (int, packed) or within
    0.5/255 (float)."""
    if bar == "identical":
        np.testing.assert_array_equal(got, want)
    elif bar < 0.5:
        np.testing.assert_allclose(got, want, atol=bar)
    elif fmt == "float":
        close = (np.abs(got - want).max(-1) < 0.5).mean()
        assert close > bar, f"only {close:.4%} of pixels within 0.5/255"
    else:
        same = (got == want).mean() if fmt == "packed" else (got == want).all(-1).mean()
        assert same > bar, f"only {same:.4%} identical"


# (backend, shading, shadows, fmt, soft, msaa, camera, split, bar): `bar`
# holds the blocks to the port's own unsharded frame, at the JAX tests' bars
# for the sharded frame against the unsharded one (tests/test_parallel.py);
# against the JAX package's sharded frame they are held to the cross-package
# bars (int and packed words >= 99.5% identical, a hard float frame >= 99.5%
# of pixels within 0.5/255, a soft one within 1e-2).
CASES = [
    ("xla", "legacy", False, "int", False, 0, "ortho", (8,), "identical"),
    ("xla", "legacy", False, "int", False, 0, "ortho", (2, 4), "identical"),
    ("pallas", "legacy", False, "int", False, 0, "ortho", (8,), 0.995),
    ("pallas", "legacy", False, "int", False, 0, "pinhole", (8,), 0.995),
    ("pallas", "phong", True, "float", False, 0, "ortho", (2, 4), 0.995),
    ("pallas", "legacy", False, "packed", False, 0, "ortho", (8,), 0.995),
    ("pallas", "lambert", False, "float", True, 0, "ortho", (8,), 1e-2),
    ("xla", "phong", True, "float", False, 4, "ortho", (2, 4), 1e-3),
]


@pytest.mark.parametrize(
    "backend,shading,shadows,fmt,soft,msaa,cam,split,bar", CASES,
    ids=[f"{c[0]}-{c[1]}-{c[3]}-{'soft' if c[4] else 'hard'}-msaa{c[5]}-{c[6]}-"
         f"{'x'.join(map(str, c[7]))}" for c in CASES])
def test_render_rows_match_jax_render_sharded(scenes, eight_devices, backend,
                                              shading, shadows, fmt, soft, msaa,
                                              cam, split, bar):
    js, ts = scenes
    jc, tc = _cameras(cam)
    kw = dict(width=W, height=H, shading=shading, shadows=shadows,
              framebuffer_dtype=fmt, soft=soft, msaa=msaa, backend=backend)
    if soft:
        kw.update(tau_depth=1.0, tau_edge=0.5)
    cfg = T.RenderConfig(**kw)
    got = _port_blocks(ts, tc, cfg, split)
    assert got.shape == ((H, W) if fmt == "packed" else (H, W, 4))
    _agree(got, T.render(ts, tc, cfg).numpy(), fmt, bar)
    jmesh = j_make_mesh(8) if len(split) == 1 else j_make_mesh_2d(*split)
    want = np.asarray(j_render_sharded(js, jc, J.RenderConfig(**kw), mesh=jmesh))
    _agree(got, want, fmt, 1e-2 if soft else 0.995)
    if fmt != "packed":
        assert np.any(got[H // 2:, :, :3] != 0), "lower blocks render nothing"


# (backend, shading, shadows, fmt, soft, cull_k): the compiled sharded frame
# on the paths of `render_sharded_jit`; cull_k 8 overflows scene 1's lists,
# where the jitted JAX frame and the compiled port frame take the brute
# kernel (B3's twin here) and the eager frame re-bins instead.
JIT_CASES = [
    ("pallas", "legacy", False, "int", False, 32),
    ("pallas", "phong", True, "packed", False, 8),
    ("pallas", "lambert", False, "float", True, 32),
    ("xla", "phong", True, "float", False, 32),
]


@pytest.mark.parametrize("backend,shading,shadows,fmt,soft,cull_k", JIT_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[3]}-{'soft' if c[4] else 'hard'}"
                              f"-k{c[5]}" for c in JIT_CASES])
def test_render_sharded_jit_matches_jax(scenes, eight_devices, backend, shading,
                                        shadows, fmt, soft, cull_k):
    """Every block of an 8-way split through `render_sharded_jit` against
    the JAX package's `render_sharded` (one jitted program) at the
    cross-package bars, and against the eager blocks: identical where no
    list overflows (the same bins at the same caps); at cull_k 8 the brute
    frame's words, which the tiled frame matches on >= 99.5% of pixels."""
    from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
    from opencl_ray_tracer_tpu_torch.parallel import render_sharded_jit

    js, ts = scenes
    jc, tc = _cameras("ortho")
    kw = dict(width=W, height=H, shading=shading, shadows=shadows,
              framebuffer_dtype=fmt, soft=soft, backend=backend, cull_k=cull_k)
    if soft:
        kw.update(tau_depth=1.0, tau_edge=0.5)
    cfg = T.RenderConfig(**kw)
    meshes = [Mesh((8,), (IMAGE_AXIS,), rank=r) for r in range(8)]
    with torch.no_grad():
        got = torch.cat([render_sharded_jit(cfg, m)(ts, tc) for m in meshes])
        eager = torch.cat([render_sharded(ts, tc, cfg, mesh=m) for m in meshes])
    got = got.numpy()
    assert got.shape == ((H, W) if fmt == "packed" else (H, W, 4))
    want = np.asarray(j_render_sharded(js, jc, J.RenderConfig(**kw),
                                       mesh=j_make_mesh(8)))
    _agree(got, want, fmt, 1e-2 if soft else 0.995)
    if cull_k == 8:
        hl = H // 8
        flags = [bool(fwd_tiled.bin_fixed(ts.pack(), shift_camera_rows(tc, r * hl),
                                          cfg.replace(height=hl)).overflow)
                 for r in range(8)]
        assert any(flags), "cull_k 8 overflows no block"
        _agree(got, eager.numpy(), fmt, 0.995)
    else:
        np.testing.assert_array_equal(got, eager.numpy())
    assert np.any(got[H // 2:] != 0), "lower blocks render nothing"


def test_partial_tile_blocks_match_whole_frame(scenes):
    """Blocks shorter than a 64-row tile and not a multiple of it (270 rows
    of 1080 is the 4-way headline split; here 24 of 96 and 40 of 120): the
    tiled hard and soft twins on each block against the whole frame."""
    _, ts = scenes
    cam = T.legacy_ortho_camera(device=CPU)
    for h, n in ((96, 4), (120, 3)):
        for kw, check in (
            (dict(shading="phong", shadows=True, framebuffer_dtype="packed"),
             "words"),
            (dict(shading="phong", shadows=True, soft=True, tau_depth=1.0,
                  tau_edge=0.5, framebuffer_dtype="float"), "soft"),
        ):
            cfg = T.RenderConfig(width=160, height=h, **kw)
            full = T.render(ts, cam, cfg).numpy()
            hl = h // n
            got = torch.cat([
                _render_rows(ts, shift_camera_rows(cam, r * hl), hl, 160, cfg)
                for r in range(n)]).numpy()
            if check == "words":
                assert (got == full).mean() > 0.995
            else:
                np.testing.assert_allclose(got, full, atol=1e-2)


def test_tiled_soft_frame_departs_from_oracle_as_jax_does(monkeypatch):
    """Why a block's soft frame is held to the unsharded one as two
    formulations are (chip_smoke.py phase 14): the tiled soft frame is not
    the oracle's, in the JAX package as in the port — the same largest
    departure at the same pixel (320x240, 10 spheres + 1 cube) — and the
    16-tau_edge cull is not the cause: with it raised to 1e4 (every tile
    takes every primitive) no pixel moves."""
    from opencl_ray_tracer_tpu.diff import render_soft as j_render_soft
    from opencl_ray_tracer_tpu.kernels.soft import render_soft_pallas as j_tiled
    from opencl_ray_tracer_tpu_torch.diff import render_soft
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled

    w, h = 320, 240
    kw = dict(width=w, height=h, shading="lambert", soft=True,
              framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.5)
    js = J.random_scene(10, 1, seed=0, bounds=(w - 10.0, h - 10.0))
    jcfg = J.RenderConfig(**kw)
    jd = np.abs(np.asarray(j_tiled(js, J.legacy_ortho_camera(), jcfg))
                - np.asarray(j_render_soft(js, J.legacy_ortho_camera(), jcfg))).max(-1)
    ts = scene_from_arrays(scene_to_arrays(js), CPU)
    cam, cfg = T.legacy_ortho_camera(device=CPU), T.RenderConfig(**kw)
    with torch.no_grad():
        tiled = soft_tiled.render_soft_tiled(ts, cam, cfg)
        td = (tiled - render_soft(ts, cam, cfg)).abs().amax(-1).numpy()
        monkeypatch.setattr(soft_tiled, "SOFT_CULL_SIGMAS", 1e4)
        uncut = soft_tiled.render_soft_tiled(ts, cam, cfg)
    assert jd.max() > 1e-2  # a departure, not rounding
    assert abs(td.max() - jd.max()) < 1e-3
    assert td.argmax() == jd.argmax()
    assert torch.equal(uncut, tiled)


def test_soft_blocks_drop_a_nearer_primitive_as_jax_does(eight_devices, monkeypatch):
    """A 16-row block's tiles miss a primitive that lies beyond 16 tau_edge
    of them but 16 tau_depth nearer than what covers the pixel, whose ~1e-8
    coverage still wins the whole frame's softmin: on this scene the
    4-block soft frame departs from the whole frame by more than 60/255, in
    the JAX package's sharded frame as in the port's blocks (which agree
    within 1e-2); with the cull raised to 1e4 tau_edge the blocks are the
    whole frame's rows within 1e-2."""
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled

    kw = dict(width=W, height=H, shading="lambert", soft=True,
              framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.5)
    js = J.random_scene(4, 2, seed=5, bounds=(float(W), float(H)))
    ts = scene_from_arrays(scene_to_arrays(js), CPU)
    cam, cfg = T.legacy_ortho_camera(device=CPU), T.RenderConfig(**kw)
    want = np.asarray(j_render_sharded(js, J.legacy_ortho_camera(),
                                       J.RenderConfig(**kw), mesh=j_make_mesh(4)))
    with torch.no_grad():
        full = T.render(ts, cam, cfg).numpy()
        got = _port_blocks(ts, cam, cfg, (4,))
        np.testing.assert_allclose(got, want, atol=1e-2)
        assert np.abs(got - full).max() > 60.0
        monkeypatch.setattr(soft_tiled, "SOFT_CULL_SIGMAS", 1e4)
        np.testing.assert_allclose(_port_blocks(ts, cam, cfg, (4,)), full, atol=1e-2)


def test_mesh_from_config_shapes_and_errors():
    m = mesh_from_config(T.RenderConfig(mesh_shape=None))
    assert m.shape == (1,) and m.axis_names == (IMAGE_AXIS,) and m.rank == 0
    assert m.reduce_groups == () and m.device is None  # no process group
    assert mesh_from_config(T.RenderConfig(mesh_shape=(1,))).shape == (1,)
    m2 = mesh_from_config(T.RenderConfig(mesh_shape=(1, 1)))
    assert m2.shape == (1, 1) and mesh_row_axes(m2) == (HOST_AXIS, IMAGE_AXIS)
    assert mesh_n_shards(m2) == 1
    assert mesh_n_shards(Mesh((2, 4), (HOST_AXIS, IMAGE_AXIS))) == 8
    with pytest.raises(ValueError, match="needs 2 ranks; only 1"):
        mesh_from_config(T.RenderConfig(mesh_shape=(2,)))
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh_2d(2, 2)
    with pytest.raises(ValueError, match="2 dims"):
        mesh_from_config(T.RenderConfig(mesh_shape=(2, 2, 2)))


def test_distributed_without_a_group():
    """One process: initialize() returns at once, one rank owns every row,
    and a card rank needs a card (no quiet gloo fallback)."""
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert distributed.world_size() == 1 and distributed.rank() == 0
    assert distributed.local_row_block(64) == (0, 64)
    assert not distributed.is_multi_host()
    addr = f"127.0.0.1:{distributed.free_port()}"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize(addr, 1, 0)
    with pytest.raises(ValueError, match="backend"):
        distributed.initialize(addr, 1, 0, backend="mpi")
    assert not torch.distributed.is_initialized()


def test_rows_and_replicas_without_a_group(scenes):
    _, ts = scenes
    frame = torch.arange(64 * 3 * 4, dtype=torch.float32).reshape(64, 3, 4)
    view = Mesh((2, 2), (HOST_AXIS, IMAGE_AXIS), rank=2)
    assert torch.equal(shard_rows(frame, view), frame[32:48])
    with pytest.raises(ValueError, match="divisible"):
        shard_rows(frame[:63], view)
    one = make_mesh(1)
    assert gather_rows(frame, one) is frame
    rep = replicate(ts, one)
    assert rep.sphere_origin is not ts.sphere_origin
    assert torch.equal(rep.sphere_origin, ts.sphere_origin)
    assert torch.equal(rep.lights.position, ts.lights.position)


def _soft_problem(backend):
    w, h = 128, 64
    cfg = T.RenderConfig(width=w, height=h, shading="lambert", soft=True,
                         framebuffer_dtype="float", tau_depth=1.0,
                         tau_edge=0.5, backend=backend)
    scene = T.random_scene(4, 2, seed=5, bounds=(float(w), float(h)), device=CPU)
    target = T.render(T.random_scene(4, 2, seed=6, bounds=(float(w), float(h)),
                                     device=CPU), T.legacy_ortho_camera(device=CPU),
                      cfg.replace(backend="reference"))
    return cfg, scene, target.detach()


@pytest.mark.parametrize("backend", ["pallas", "reference"])
def test_one_rank_mesh_step_equals_one_device_step(backend):
    """The reference's call shape, make_train_step(camera, config, optimizer,
    mesh=mesh) (__graft_entry__.py:75), on a one-rank mesh: the same losses
    and scenes as the one-device step, bit for bit, over 3 Adam steps."""
    cfg, scene, target = _soft_problem(backend)
    cam = T.legacy_ortho_camera(device=CPU)
    runs = []
    for mesh in (None, make_mesh(1)):
        optimizer = adam(0.1)
        step = make_train_step(cam, cfg, optimizer, mesh=mesh)
        state = init_train_state(scene, optimizer)
        rows = target if mesh is None else shard_rows(target, mesh)
        losses = []
        for _ in range(3):
            state, loss = step(state, rows)
            losses.append(loss)
        runs.append((losses, state))
    (la, sa), (lb, sb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert sb.step == 3
    for k in ("sphere_origin", "sphere_radius", "sphere_colour", "tri_verts"):
        assert torch.equal(getattr(sa.scene, k), getattr(sb.scene, k)), k
    assert not torch.equal(sb.scene.sphere_origin, scene.sphere_origin)


def test_graft_entry_call_shape_matches_jax():
    """The body of __graft_entry__._dryrun_body through the port on one rank
    (its mesh, call shapes and inputs; backend "reference" so the JAX side
    needs no interpret-mode kernel): the loss equals JAX's."""
    h, w = 8, 128
    kw = dict(width=w, height=h, shading="phong", shadows=True, soft=True,
              framebuffer_dtype="float", backend="reference")

    mesh = make_mesh(1)
    camera = T.legacy_ortho_camera(device=CPU)
    optimizer = adam(1e-2)
    step = make_train_step(camera, T.RenderConfig(**kw), optimizer, mesh=mesh)
    target_sharded = shard_rows(torch.zeros((h, w, 4)), mesh)
    state = init_train_state(replicate(T.create_scene1(device=CPU), mesh), optimizer)
    state, loss = step(state, target_sharded)

    from opencl_ray_tracer_tpu.parallel import init_train_state as j_init
    from opencl_ray_tracer_tpu.parallel import make_train_step as j_step
    from opencl_ray_tracer_tpu.parallel import replicate as j_replicate
    from opencl_ray_tracer_tpu.parallel import shard_rows as j_shard_rows

    jmesh = j_make_mesh(1)
    jopt = optax.adam(1e-2)
    jstep = j_step(J.legacy_ortho_camera(), J.RenderConfig(**kw), jopt, mesh=jmesh)
    jstate = j_init(j_replicate(J.create_scene1(), jmesh), jopt)
    jstate, jloss = jstep(jstate, j_shard_rows(jnp.zeros((h, w, 4)), jmesh))
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(state.scene.sphere_origin.detach().numpy(),
                               np.asarray(jstate.scene.sphere_origin), rtol=1e-5)


def test_train_step_rejects_msaa_bad_split_and_axis():
    cfg = T.RenderConfig(width=W, height=H, shading="lambert", soft=True,
                         framebuffer_dtype="float")
    cam = T.legacy_ortho_camera(device=CPU)
    with pytest.raises(ValueError, match="msaa"):
        make_train_step(cam, cfg.replace(msaa=4), adam(1e-2), mesh=make_mesh(1))
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(cam, cfg, adam(1e-2), mesh=Mesh((3,), (IMAGE_AXIS,)))
    with pytest.raises(ValueError, match="axis"):
        make_train_step(cam, cfg, adam(1e-2), mesh=make_mesh(1), axis="pixels")
    step = make_train_step(cam, cfg, adam(1e-2), mesh=Mesh((2,), (IMAGE_AXIS,)))
    state = init_train_state(T.create_scene1(device=CPU), adam(1e-2))
    with pytest.raises(ValueError, match="rows"):
        step(state, torch.zeros((H, W, 4)))  # the whole frame, not this rank's
