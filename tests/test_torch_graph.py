"""Port parity for the compiled path: the JAX package's `jit` forms against
the port's fixed-K, no-host-read forms, on the CPU (the kernels' plain twins,
JAX's Pallas kernels in interpret mode), inputs made from a seed.

- the hard frame: `fwd_tiled._render_tiled_jit` against `jax.jit` of JAX's
  `render_tiled_packed`, on both branches of its `lax.cond` (the golden bar,
  >= 99.9% of pixels identical, where the tiled kernel runs; the bar of
  tests/test_torch_fwd_brute.py for B3's twin against JAX's brute frame where
  the lists overflow), with equal overflow flags;
- the soft frame: `soft_tiled._soft_tiled_core` against JAX's
  `render_soft_tiled` (always fixed K) at a K that overflows and one that does
  not: images within 0.05/255 on every pixel, gradients of mean(img^2)
  within 1e-3 normalised by JAX's largest;
- the eager soft frame (`render_soft_tiled`, which reads the overflow flag
  and runs one branch) against `_soft_tiled_core` on both branches, bit for
  bit;
- `runtime.graph.cond` on CPU tensors: both branches run and each output
  tensor is selected, on nested trees, for both values of the predicate;
  branches whose trees differ are refused;
- the `_soft_tiled_core` autograd Function on both branches against the
  eager pair that stays (`SoftTiledFunction` over the tables, as
  `render_soft_tiled` composes it, and `_soft_render_core`), image and the
  gradient of every scene leaf, camera tensor and both temperatures, within
  1e-6 of each leaf's largest magnitude;
- `runtime.graph.jit` on CPU tensors (it calls the function), the
  `jit=True` train step on the CPU (the eager step's result; with a mesh
  that has no group, the one-device step's; on backend "xla", the eager
  "xla" step's) and what it refuses, and the two-point slope of
  `bench_util` against a fake clock.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as J
import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu.kernels import fwd_tiled as jft
from opencl_ray_tracer_tpu.kernels import soft_tiled as jst
from opencl_ray_tracer_tpu_torch import bench_util
from opencl_ray_tracer_tpu_torch.kernels import fwd, fwd_tiled, soft, soft_tiled
from opencl_ray_tracer_tpu_torch.parallel import (
    adam,
    init_train_state,
    make_train_step,
)
from opencl_ray_tracer_tpu_torch.parallel.train import scene_leaves
from opencl_ray_tracer_tpu_torch.runtime import graph
from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays, scene_to_arrays
from opencl_ray_tracer_tpu_torch.utils import tracing

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _pile():
    """40 spheres on one spot: every tile they cover exceeds K = 32
    (tests/test_pallas_tiled.py:46-48)."""
    return J.random_scene(40, 0, seed=9, bounds=(60.0, 40.0))


def _port(js):
    return scene_from_arrays(scene_to_arrays(js), CPU)


# ---- the hard frame ---------------------------------------------------------

HW, HH = 160, 120


@pytest.mark.parametrize("case", ["scene1", "pile"])
def test_render_tiled_jit_matches_jax_cond(case):
    js = J.create_scene(1) if case == "scene1" else _pile()
    ts = _port(js)
    shading, shadows = ("phong", True) if case == "scene1" else ("legacy", False)
    kw = dict(width=HW, height=HH, shading=shading, shadows=shadows,
              framebuffer_dtype="packed")
    jcfg, tcfg = J.RenderConfig(**kw), T.RenderConfig(**kw)
    jc, tc = J.legacy_ortho_camera(), T.legacy_ortho_camera(device=CPU)
    jp, tp = js.pack(), ts.pack()

    want = np.asarray(jax.jit(
        lambda p, c: jft.render_tiled_packed(p, c, jcfg, interpret=True))(jp, jc))
    jbins = jft.bin_scene(jp, height=HH, width=HW, k=jcfg.cull_k, shadows=shadows,
                          shadow_k=jcfg.shadow_cull_k, camera=jc)
    tbins = fwd_tiled.bin_fixed(tp, tc, tcfg)
    assert bool(tbins.overflow) == bool(jbins.overflow) == (case == "pile")

    before = (tracing.counter("launch.B1"), tracing.counter("launch.B3"))
    got = fwd_tiled._render_tiled_jit(tp, tc, tbins, height=HH, width=HW,
                                      shading=shading, shadows=shadows,
                                      out_format="packed")
    assert (tracing.counter("launch.B1"), tracing.counter("launch.B3")) == before  # twins
    assert got.shape == want.shape == (HH, HW) and got.dtype == torch.int32
    same = (got.numpy() == want).mean()
    assert same >= 0.999, f"only {same:.4%} of the words identical"
    assert (want != fwd_tiled.ALPHA_BITS).any(), "the camera sees nothing"
    # the whole compiled frame (pack, bins at the caps, both branches)
    whole = fwd_tiled.render_tiled_fixed(ts, tc, tcfg)
    assert torch.equal(whole, got)


@pytest.mark.parametrize("overflow", [False, True])
def test_tiled_branches_zero_where_not_taken(overflow):
    """Both branches of the compiled frame called with the overflow flag as
    `run_if` (what `cond` does on the card outside a capture): the one whose
    branch is not taken leaves zeros (what its skipped CUDA launch leaves),
    the other its frame."""
    ts = _port(_pile() if overflow else J.create_scene(1))
    tc = T.legacy_ortho_camera(device=CPU)
    cfg = T.RenderConfig(width=HW, height=HH, shading="legacy",
                         framebuffer_dtype="float")
    packed = ts.pack()
    bins = fwd_tiled.bin_fixed(packed, tc, cfg)
    brute_render, tiled_render = fwd_tiled._frame_branches(
        packed, tc, bins, height=HH, width=HW, shading="legacy", shadows=False,
        out_format="float")
    flag = bins.overflow.to(torch.int32)
    tiled, brute = tiled_render(run_if=flag), brute_render(run_if=flag)
    assert bool(flag) == overflow
    taken, skipped = (brute, tiled) if overflow else (tiled, brute)
    assert not skipped.any()
    assert (taken[..., 3] == 255.0).all()
    if overflow:
        want = fwd.render_pallas_packed(packed, tc, cfg)
        assert torch.equal(brute, want)


# ---- the soft frame ---------------------------------------------------------

SW, SH = 128, 64
LEAVES = ("sphere_origin", "sphere_radius", "sphere_colour", "tri_verts",
          "tri_colour")


def _soft_cfgs(shading, shadows):
    kw = dict(width=SW, height=SH, shading=shading, shadows=shadows, soft=True,
              framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.5)
    return J.RenderConfig(**kw), T.RenderConfig(**kw)


def _soft_case(case):
    if case == "pile":  # overflows K = 32: the brute soft kernels' branch
        return _pile(), "lambert", False
    return J.random_scene(5, 2, seed=4, bounds=(120.0, 60.0)), "phong", True


def _core(ts, tcfg, cam):
    return soft_tiled._soft_tiled_core(
        ts.pack(), cam, tcfg.tau_depth, tcfg.tau_edge, SH, SW, tcfg.shading,
        tcfg.shadows, tcfg.cull_k, tcfg.shadow_cull_k)


@pytest.mark.parametrize("case", ["pile", "few"])
def test_soft_tiled_core_matches_jax(case):
    js, shading, shadows = _soft_case(case)
    ts = _port(js)
    jcfg, tcfg = _soft_cfgs(shading, shadows)
    jc, tc = J.legacy_ortho_camera(), T.legacy_ortho_camera(device=CPU)
    jbins = jst._bin_soft(js.pack(), jnp.float32(0.5), jc, height=SH, width=SW,
                          k=jcfg.cull_k, shadows=shadows, shadow_k=jcfg.shadow_cull_k)
    tbins = soft_tiled._bin_soft(ts.pack(), 0.5, tc, height=SH, width=SW,
                                 k=tcfg.cull_k, shadows=shadows,
                                 shadow_k=tcfg.shadow_cull_k)
    assert bool(tbins.overflow) == bool(jbins.overflow) == (case == "pile")

    want = np.asarray(jst.render_soft_tiled(js, jc, jcfg, interpret=True))
    before = (tracing.counter("launch.B4"), tracing.counter("launch.B6"))
    with torch.no_grad():
        got = _core(ts, tcfg, tc).numpy()
    assert (tracing.counter("launch.B4"), tracing.counter("launch.B6")) == before
    assert got.shape == want.shape == (SH, SW, 4)
    assert (want[..., :3] > 1.0).any(), "the camera sees nothing"
    err = np.abs(got - want).max()
    assert err < 0.05, f"max error {err}"

    # gradients of mean(img^2) for every scene leaf and the light position
    g = jax.grad(lambda s: jnp.mean(
        jst.render_soft_tiled(s, jc, jcfg, interpret=True)[..., :3] ** 2))(js)
    want_g = ([np.asarray(getattr(g, k)) for k in LEAVES]
              + [np.asarray(g.lights.position)])
    leaves = [getattr(ts, k) for k in LEAVES] + [ts.lights.position]
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = torch.mean(_core(ts, tcfg, tc)[..., :3] ** 2)
    got_g = [x.numpy() for x in torch.autograd.grad(loss, leaves)]
    for name, a, b in zip(LEAVES + ("lights.position",), got_g, want_g):
        assert np.all(np.isfinite(a)) and a.shape == b.shape, name
        if not b.size:  # the pile has no triangles
            continue
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-3, err_msg=name)
    assert np.any(got_g[0] != 0), "no sphere-origin gradient"


def test_soft_branch_not_taken_is_zero():
    """On a frame that fits its lists, the brute soft forward is zeros and
    the tiled one the eager frame, bit for bit."""
    js, shading, shadows = _soft_case("few")
    ts = _port(js)
    _, tcfg = _soft_cfgs(shading, shadows)
    tc = T.legacy_ortho_camera(device=CPU)
    packed = ts.pack()
    flag = torch.zeros((), dtype=torch.int32)
    with torch.no_grad():
        brute = soft._soft_render_core(packed, tc, 1.0, 0.5, SH, SW, shading,
                                       shadows, False, run_if=flag, want=1)
        got = _core(ts, tcfg, tc)
        eager = soft_tiled.render_soft_tiled(ts, tc, tcfg)
    assert not brute.any()
    assert torch.equal(got, eager)


@pytest.mark.parametrize("case", ["pile", "few"])
def test_eager_soft_frame_equals_core(case):
    """The eager `render_soft_tiled` runs only the branch the overflow flag
    takes (the brute soft frame on the pile, the tiled one on "few");
    `_soft_tiled_core` runs both and selects on the card. Same image and
    same leaf gradients, bit for bit."""
    js, shading, shadows = _soft_case(case)
    _, tcfg = _soft_cfgs(shading, shadows)
    tc = T.legacy_ortho_camera(device=CPU)
    outs = []
    for render in (lambda s: soft_tiled.render_soft_tiled(s, tc, tcfg),
                   lambda s: _core(s, tcfg, tc)):
        ts = _port(js)
        leaves = [getattr(ts, k) for k in LEAVES] + [ts.lights.position]
        for leaf in leaves:
            leaf.requires_grad_(True)
        img = render(ts)
        grads = torch.autograd.grad(torch.mean(img[..., :3] ** 2), leaves)
        outs.append((img.detach(), grads))
    (ie, ge), (ic, gc) = outs
    assert torch.equal(ie, ic)
    assert (ie[..., :3] > 1.0).any()
    for name, a, b in zip(LEAVES + ("lights.position",), ge, gc):
        assert torch.equal(a, b), name
    assert ge[0].abs().max() > 0


@pytest.mark.parametrize("case", ["few", "pile"])
def test_soft_core_function_matches_eager_pair(case):
    """`_soft_tiled_core`'s Function (forward and backward each a cond) on
    the tiled branch ("few" fits its lists) and the brute one (the pile
    overflows K 32), against the eager composition of that branch with
    autograd: the image, and the gradients of the scene's leaves, the
    light positions, the camera's six tensors and both temperatures."""
    js, shading, shadows = _soft_case(case)
    _, tcfg = _soft_cfgs(shading, shadows)

    def leaves_of(ts):
        cam = T.legacy_ortho_camera(device=CPU)
        cam = dataclasses.replace(cam, **{f.name: getattr(cam, f.name).clone()
                                          for f in dataclasses.fields(cam)
                                          if f.name != "normalize"})
        taus = (torch.tensor(1.0), torch.tensor(0.5))
        leaves = ([getattr(ts, k) for k in LEAVES] + [ts.lights.position]
                  + [getattr(cam, n) for n in ("o0", "dox", "doy", "d0", "ddx",
                                               "ddy")] + list(taus))
        for leaf in leaves:
            leaf.requires_grad_(True)
        return cam, taus, leaves

    def eager(packed, cam, tau_d, tau_e):
        if case == "pile":
            return soft._soft_render_core(packed, cam, tau_d, tau_e, SH, SW,
                                          shading, shadows, cam.normalize)
        bins = soft_tiled._bin_soft(packed, tau_e, cam, height=SH, width=SW,
                                    k=tcfg.cull_k, shadows=shadows,
                                    shadow_k=tcfg.shadow_cull_k)
        tables = soft_tiled._gather_soft_tables(packed, cam, tau_e, bins)
        params = fwd._camera_params(cam, packed.lights)
        cfg = dict(n_lights=packed.lights.position.shape[0], shading=shading,
                   shadows=shadows, projective=False, nty=bins.nty,
                   ntx=bins.ntx, height=SH, width=SW)
        return soft_tiled.SoftTiledFunction.apply(
            params, torch.stack([tau_d, tau_e]), *tables, bins.counts, cfg)

    def core(packed, cam, tau_d, tau_e):
        return soft_tiled._soft_tiled_core(packed, cam, tau_d, tau_e, SH, SW,
                                           shading, shadows, tcfg.cull_k,
                                           tcfg.shadow_cull_k)

    outs = []
    for render in (eager, core):
        ts = _port(js)
        cam, taus, leaves = leaves_of(ts)
        img = render(ts.pack(), cam, *taus)
        grads = torch.autograd.grad(torch.mean(img[..., :3] ** 2), leaves,
                                    allow_unused=True)
        outs.append((img.detach(), [torch.zeros_like(x) if g is None else g
                                    for x, g in zip(leaves, grads)]))
    (ie, ge), (ic, gc) = outs
    assert (ie[..., :3] > 1.0).any()
    assert (ic - ie).abs().max() <= 1e-6 * ie.abs().max()
    names = LEAVES + ("lights.position", "o0", "dox", "doy", "d0", "ddx", "ddy",
                      "tau_d", "tau_e")
    for name, a, b in zip(names, gc, ge):
        if not b.numel():  # the pile has no triangles
            continue
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert (a - b).abs().max() <= 1e-6 * b.abs().max(), name
    assert ge[0].abs().max() > 0 and ge[-1].abs() > 0 and ge[-2].abs() > 0


# ---- runtime.graph on CPU tensors ----------------------------------------------


@dataclasses.dataclass
class _Pair:
    img: torch.Tensor
    words: tuple
    tag: str = "t"


@pytest.mark.parametrize("taken", [True, False])
def test_cond_selects_leaf_by_leaf(taken):
    """On CPU tensors both branches run with no `run_if`, and every tensor of
    the result (in a tuple, a dataclass, a dict) is the branch's own where
    the predicate takes it."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    w = torch.from_numpy(rng.integers(0, 99, (6,)).astype(np.int32))
    flags = []

    def branch(sign):
        def fn(a, b, run_if):
            flags.append(run_if)
            return (a * sign, _Pair(a + sign, (b * sign, b + 1)), {"n": b - sign})
        return fn

    got = graph.cond(torch.tensor(taken), branch(2), branch(-3), (x, w))
    want = branch(2 if taken else -3)(x, w, None)
    assert flags == [None, None, None]
    assert isinstance(got[1], _Pair) and got[1].tag == "t"
    got_leaves, want_leaves = [], []
    assert graph._flatten(got, got_leaves) == graph._flatten(want, want_leaves)
    assert len(got_leaves) == 5
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_cond_rejects_branches_that_differ():
    x = torch.ones(3)
    pred = torch.tensor(True)
    same = lambda run_if: (x, x.int())  # noqa: E731
    for other, match in ((lambda run_if: (x, x), "differs"),
                         (lambda run_if: (x, torch.ones(4, dtype=torch.int32)),
                          "differs"),
                         (lambda run_if: [x, x.int()], "structures"),
                         (lambda run_if: (x, x.int(), x), "structures")):
        with pytest.raises(ValueError, match=match):
            graph.cond(pred, same, other)
    with pytest.raises(TypeError, match="one bool"):
        graph.cond(torch.tensor([1.0]), same, same)
    with pytest.raises(TypeError, match="one bool"):
        graph.cond(torch.tensor([True, False]), same, same)




def test_graph_jit_on_cpu_calls_the_function():
    calls = []

    def fn(packed, camera, bins, *, scale, mode):
        calls.append(mode)
        return {"a": packed.sph_origin * scale, "b": (camera.o0 + bins["x"],)}

    f = graph.jit(fn, static=("mode",))
    ts = T.create_scene1(device=CPU)
    cam = T.legacy_ortho_camera(device=CPU)
    x = torch.arange(3.0)
    out = f(ts.pack(), cam, {"x": x}, scale=2.0, mode="m")
    assert calls == ["m"]
    assert torch.equal(out["a"], ts.pack().sph_origin * 2.0)
    assert torch.equal(out["b"][0], cam.o0 + x)


def test_graph_tree_round_trip():
    """Tensors anywhere in dataclasses, NamedTuples, dicts and lists come
    back in place; other values are part of the structure."""
    ts = T.create_scene1(device=CPU)
    packed = ts.pack()
    tree = ((packed, T.legacy_ortho_camera(device=CPU)),
            {"k": [torch.ones(2), 3, "s"]})
    leaves = []
    spec = graph._flatten(tree, leaves)
    hash(spec)
    assert all(isinstance(t, torch.Tensor) for t in leaves)
    back = graph._unflatten(spec, iter(leaves))
    assert back[0][0].n_spheres == packed.n_spheres
    assert back[0][0].sph_origin is packed.sph_origin
    assert back[0][1].normalize is False and back[1]["k"][1:] == [3, "s"]
    other = []
    assert graph._flatten(((packed, T.pinhole_camera(
        (0.0, 0.0, 9.0), (0.0, 0.0, 0.0), device=CPU)), {"k": [torch.ones(2), 3, "s"]}),
        other) != spec  # a new static value: a new capture


def test_device_const_is_made_once_per_value():
    a = graph.device_const(np.array([1.0, 2.0], np.float32), CPU)
    b = graph.device_const([1.0, 2.0], "cpu")
    assert a is b and a.dtype == torch.float32
    assert graph.device_const([1.0, 3.0], CPU) is not a
    half = graph.device_scalar(0.5, CPU)
    assert half.shape == () and half.item() == 0.5
    t = torch.tensor(2.0, requires_grad=True)
    assert graph.device_scalar(t, CPU) is t


# ---- the jit=True train step -------------------------------------------------


def _train_problem():
    w, h = 128, 64
    cfg = T.RenderConfig(width=w, height=h, shading="lambert", soft=True,
                         framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.75)
    cam = T.legacy_ortho_camera(device=CPU)
    rng = np.random.default_rng(11)
    target = torch.from_numpy(rng.uniform(0, 255, (h, w, 4)).astype(np.float32))
    init = T.Scene.build(
        device=CPU, sphere_origin=[[w * 0.6, h * 0.4, -60.0]],
        sphere_radius=[h * 0.22], sphere_colour=[[0.6, 0.5, 0.5, 255.0]])
    return cfg, cam, target, init


def test_jit_train_step_on_cpu_equals_eager_step():
    cfg, cam, target, init = _train_problem()
    opt = adam(0.5)
    eager = make_train_step(cam, cfg, opt)
    jitted = make_train_step(cam, cfg, opt, jit=True)
    a, b = init_train_state(init, opt), init_train_state(init, opt)
    for i in range(3):
        a, la = eager(a, target)
        b, lb = jitted(b, target)
        assert la.item() == lb.item(), i
        for k, x in scene_leaves(a.scene).items():
            torch.testing.assert_close(scene_leaves(b.scene)[k], x, rtol=0, atol=0,
                                       msg=f"step {i} {k}")
    assert b.step == 3


def test_jit_train_step_rejects_mesh_and_other_backends():
    """What `jit=True` takes: a mesh (one with no process group runs the
    one-device step through the row-shifted camera, the `mesh=None` step bit
    for bit; several ranks: tests/test_torch_distributed.py) and every
    backend (the torch-autograd oracle at fixed temperatures for "xla", the
    eager "xla" step bit for bit). What it still refuses: msaa > 1, a height
    the mesh does not split, an axis the mesh lacks, and on a card a mesh
    whose groups are not NCCL (a one-rank gloo group here)."""
    import torch.distributed as dist

    from opencl_ray_tracer_tpu_torch.parallel import IMAGE_AXIS, Mesh, make_mesh
    from opencl_ray_tracer_tpu_torch.parallel.train import _require_nccl

    cfg, cam, target, init = _train_problem()

    def run(c, **kw):
        opt = adam(0.5)
        step = make_train_step(cam, c, opt, **kw)
        state, losses = init_train_state(init, opt), []
        for _ in range(2):
            state, loss = step(state, target)
            losses.append(loss.clone())
        return losses, scene_leaves(state.scene)

    for c, kw_a, kw_b in (
            (cfg, dict(mesh=Mesh((1,), (IMAGE_AXIS,)), jit=True), dict(jit=True)),
            (cfg.replace(backend="xla"), dict(jit=True), dict(jit=False))):
        (la, sa), (lb, sb) = run(c, **kw_a), run(c, **kw_b)
        assert all(torch.equal(a, b) for a, b in zip(la, lb)), kw_a
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (kw_a, k)
    with pytest.raises(ValueError, match="msaa"):
        make_train_step(cam, cfg.replace(msaa=4), adam(0.1), jit=True)
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(cam, cfg, adam(0.1), mesh=Mesh((3,), (IMAGE_AXIS,)),
                        jit=True)
    with pytest.raises(ValueError, match="axis"):
        make_train_step(cam, cfg, adam(0.1), mesh=Mesh((1,), (IMAGE_AXIS,)),
                        axis="pixels", jit=True)
    from opencl_ray_tracer_tpu_torch.parallel import distributed

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{distributed.free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        assert mesh.reduce_groups
        _require_nccl(mesh, CPU)  # gloo ranks on the CPU: the tests' meshes
        with pytest.raises(ValueError, match="NCCL"):
            _require_nccl(mesh, torch.device("cuda", 0))
    finally:
        dist.destroy_process_group()


def test_adam_is_capturable_only_on_a_card():
    p = torch.zeros(3, requires_grad=True)
    assert adam(0.1)([p]).defaults["capturable"] is False


# ---- the slope helpers ---------------------------------------------------------


def _fake_clock(per_frame, const):
    seen = []

    def total_us(fn, camera, n, reps, scalar_body):
        seen.append((n, reps, scalar_body))
        return const + per_frame * n

    return total_us, seen


@pytest.mark.parametrize("n,n1", [(100, 12), (300, 37), (30, 4), (20, 4),
                                  (10, 4), (6, 3), (2, 1)])
def test_slope_baseline_and_value(n, n1):
    total_us, seen = _fake_clock(7.5, 30_000.0)
    us = bench_util._slope_us(None, None, n, 5, False, total_us=total_us)
    assert seen == [(n1, 5, False), (n, 5, False)]
    assert us == pytest.approx(7.5)


def test_slope_degenerate_and_failed():
    total_us, seen = _fake_clock(7.5, 30.0)
    assert bench_util._slope_us(None, None, 1, 3, True, total_us=total_us) \
        == pytest.approx(37.5)
    assert seen == [(1, 3, True)]
    flat, _ = _fake_clock(0.0, 30.0)
    with pytest.raises(bench_util.SlopeError, match="invalid slope"):
        bench_util._slope_us(None, None, 50, 5, False, total_us=flat)
    falling, _ = _fake_clock(-1.0, 30_000.0)
    with pytest.raises(bench_util.SlopeError):
        bench_util._slope_us(None, None, 50, 5, False, total_us=falling)


def test_graph_timing_needs_a_card():
    with pytest.raises(RuntimeError, match="card"):
        bench_util.device_frame_time_us(lambda c: None,
                                        T.legacy_ortho_camera(device=CPU), 8, 1)
