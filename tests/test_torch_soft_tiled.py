"""Port parity: the tiled soft path (kernels/soft_tiled.py) — binning,
per-tile tables, and the forward and backward of SoftTiledFunction, which on
the CPU run the kernels' plain twin and its autograd — against the JAX
package's kernels/soft_tiled.py in Pallas interpret mode, on the same scene
arrays.

Bars: bins exactly equal; tables allclose (rtol 1e-5, atol 1e-4); images
within 0.05/255 on every pixel; gradients of every scene leaf, normalised by
the JAX gradient's largest magnitude, within 1e-3 (2e-3 pinhole).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as J
import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu.kernels import soft_tiled as jst
from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays, scene_to_arrays
from opencl_ray_tracer_tpu_torch.utils import tracing

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

CPU = torch.device("cpu")
W, H = 256, 128  # 2x2 tiles
PINHOLE = dict(position=(128.0, 64.0, 200.0), look_at=(128.0, 64.0, -60.0),
               fov_degrees=65.0, width=W, height=H)
MODES = [("legacy", False), ("lambert", False), ("lambert", True),
         ("phong", True)]
BIN_FIELDS = ("t_idx", "t_valid", "s_idx", "s_valid", "tsh_idx", "tsh_valid",
              "ssh_idx", "ssh_valid", "counts", "overflow")
LEAVES = ("sphere_origin", "sphere_radius", "sphere_colour", "tri_verts",
          "tri_colour")
LIGHT_LEAVES = ("position", "colour", "intensity", "ambient")


@pytest.fixture(scope="module")
def scenes():
    js = J.random_scene(5, 3, seed=4, bounds=(250.0, 120.0))
    return js, scene_from_arrays(scene_to_arrays(js), CPU)


def _cameras(kind):
    if kind == "ortho":
        return J.legacy_ortho_camera(), T.legacy_ortho_camera(device=CPU)
    return J.pinhole_camera(**PINHOLE), T.pinhole_camera(**PINHOLE, device=CPU)


def _cfgs(shading, shadows):
    kw = dict(width=W, height=H, shading=shading, shadows=shadows, soft=True,
              framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.5)
    return J.RenderConfig(**kw), T.RenderConfig(**kw)


def _bins(scenes, cam_kind):
    js, ts = scenes
    jc, tc = _cameras(cam_kind)
    jb = jst._bin_soft(js.pack(), jnp.float32(0.5), jc, height=H, width=W,
                       k=32, shadows=True, shadow_k=64)
    tb = S._bin_soft(ts.pack(), 0.5, tc, height=H, width=W, k=32,
                     shadows=True, shadow_k=64)
    return jb, tb, jc, tc


@pytest.mark.parametrize("cam_kind", ["ortho", "pinhole"])
def test_bin_soft_matches_jax(scenes, cam_kind):
    jb, tb, _, _ = _bins(scenes, cam_kind)
    for f in BIN_FIELDS:
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.shape == b.shape, f
        assert np.array_equal(a, b), f
    for f in ("k_tri", "k_sph", "k_sh_tri", "k_sh_sph", "nty", "ntx",
              "projective"):
        assert getattr(jb, f) == getattr(tb, f), f
    assert tb.k_sh_tri and tb.k_sh_sph and int(tb.counts[:, 2:].sum()) > 0


# (camera, shadows, K, shadow K) -> (k_tri, k_sph, k_sh_tri, k_sh_sph) for the
# fixture's 36 triangles and 5 spheres, each padded to 128: the caps rounded
# up to CH (8) and to the rounded primitive count; a pinhole frame's shadow
# caps are the padded counts.
SOFT_CAPS = [
    ("ortho", True, 32, 64, (32, 8, 40, 8)),
    ("ortho", True, 5, 3, (8, 8, 8, 8)),
    ("ortho", True, 20, 100, (24, 8, 40, 8)),
    ("ortho", False, 32, 64, (32, 8, 0, 0)),
    ("pinhole", True, 32, 64, (32, 8, 128, 128)),
    ("pinhole", True, 5, 3, (8, 8, 128, 128)),
    ("pinhole", False, 32, 64, (32, 8, 0, 0)),
]


@pytest.mark.parametrize("cam_kind,shadows,k,shadow_k,caps", SOFT_CAPS)
def test_soft_bin_sizes_are_the_rounded_caps(scenes, cam_kind, shadows, k,
                                             shadow_k, caps):
    """`_soft_bin_sizes`, the static fields that both `_bin_soft_plain` and
    `_bin_soft_cuda` are given, against the caps by hand, the JAX package's
    bins and the CPU `_bin_soft`'s."""
    js, ts = scenes
    jc, tc = _cameras(cam_kind)
    kw = dict(height=H, width=W, k=k, shadows=shadows, shadow_k=shadow_k)
    sizes = S._soft_bin_sizes(ts.pack(), projective=cam_kind == "pinhole", **kw)
    names = ("k_tri", "k_sph", "k_sh_tri", "k_sh_sph")
    assert tuple(sizes[n] for n in names) == caps
    assert (sizes["nty"], sizes["ntx"], sizes["projective"]) == (2, 2, cam_kind == "pinhole")
    jb = jst._bin_soft(js.pack(), jnp.float32(0.5), jc, **kw)
    tb = S._bin_soft(ts.pack(), 0.5, tc, **kw)
    for n, v in sizes.items():
        assert getattr(jb, n) == v and getattr(tb, n) == v, n


def test_cpu_bin_soft_runs_the_twin_and_launches_nothing(scenes, monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("CPU tensors reached the CUDA binning wrapper")

    monkeypatch.setattr(S, "_bin_soft_cuda", no_kernel)
    tracing.reset()
    _, ts = scenes
    packed, tc = ts.pack(), _cameras("ortho")[1]
    kw = dict(height=H, width=W, k=32, shadows=True, shadow_k=64)
    got = S._bin_soft(packed, 0.5, tc, **kw)
    want = S._bin_soft_plain(packed, torch.tensor(0.5), tc,
                             **S._soft_bin_sizes(packed, projective=False, **kw))
    for f in BIN_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert tracing.counter("launch.bin_soft") == 0


def _bad_args(scenes, fault):
    """`_bin_soft_cuda`'s arguments on the CPU with one fault."""
    import dataclasses

    _, ts = scenes
    packed, cam = ts.pack(), _cameras("ortho")[1]
    tau = torch.tensor(0.5)
    if fault == "tau float64":
        tau = tau.double()
    elif fault == "tau shape":
        tau = tau.reshape(1)
    elif fault == "radius int":
        packed = dataclasses.replace(packed, sph_radius=packed.sph_radius.int())
    elif fault == "v0 strided":
        packed = dataclasses.replace(packed, tri_v0=packed.tri_v0.T.contiguous().T)
    elif fault == "radius shape":
        packed = dataclasses.replace(packed,
                                     sph_radius=packed.sph_radius[:, :64].contiguous())
    elif fault == "lights shape":
        lights = dataclasses.replace(packed.lights,
                                     position=packed.lights.position.reshape(-1))
        packed = dataclasses.replace(packed, lights=lights)
    elif fault == "camera shape":
        cam = dataclasses.replace(cam, o0=torch.zeros(4))
    sizes = S._soft_bin_sizes(packed, height=H, width=W, k=32, shadows=True,
                              shadow_k=64, projective=False)
    return packed, tau, cam, sizes


@pytest.mark.parametrize("fault,error,match", [
    ("tau float64", TypeError, "tau_e: expected torch.float32"),
    ("tau shape", ValueError, r"tau_e: shape \(1,\)"),
    ("radius int", TypeError, "sph_radius: expected torch.float32"),
    ("v0 strided", ValueError, "tri_v0: must be contiguous"),
    ("radius shape", ValueError, "sph_radius: shape"),
    ("lights shape", ValueError, "light position: shape"),
    ("camera shape", ValueError, "o0: shape"),
    ("none", ValueError, "runs on cuda tensors"),
])
def test_bin_soft_cuda_checks_its_arguments(scenes, fault, error, match):
    """The CUDA wrapper checks every tensor it passes on before it loads the
    library, so a wrong dtype, shape or layout (and, with none of those,
    CPU tensors) raises here without a card or nvcc."""
    packed, tau, cam, sizes = _bad_args(scenes, fault)
    with pytest.raises(error, match=match):
        S._bin_soft_cuda(packed, tau, cam, **sizes)


@pytest.mark.parametrize("cam_kind", ["ortho", "pinhole"])
def test_gather_soft_tables_match_jax(scenes, cam_kind):
    jb, tb, jc, tc = _bins(scenes, cam_kind)
    js, ts = scenes
    want = jst._gather_soft_tables(js.pack(), jc, jnp.float32(0.5), jb)
    got = S._gather_soft_tables(ts.pack(), tc, 0.5, tb)
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(b.detach().numpy(), a, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("cam_kind", ["ortho", "pinhole"])
@pytest.mark.parametrize("shading,shadows", MODES)
def test_render_soft_tiled_matches_jax(scenes, cam_kind, shading, shadows):
    js, ts = scenes
    jc, tc = _cameras(cam_kind)
    jcfg, tcfg = _cfgs(shading, shadows)
    want = np.asarray(jst.render_soft_tiled(js, jc, jcfg, interpret=True))
    before = (tracing.counter("launch.B4"), tracing.counter("launch.B5"))
    got = S.render_soft_tiled(ts, tc, tcfg)
    assert (tracing.counter("launch.B4"), tracing.counter("launch.B5")) == before  # CPU: the twin
    got = got.detach().numpy()
    assert got.shape == want.shape == (H, W, 4)
    if shading != "legacy":
        assert (want[..., :3] > 1.0).any(), "the camera sees nothing"
    err = np.abs(got - want).max()
    assert err < 0.05, f"max error {err}"


def _leaf_grads_jax(js, jc, jcfg):
    g = jax.grad(lambda s: jnp.mean(
        jst.render_soft_tiled(s, jc, jcfg, interpret=True)[..., :3] ** 2))(js)
    return ([np.asarray(getattr(g, k)) for k in LEAVES]
            + [np.asarray(getattr(g.lights, k)) for k in LIGHT_LEAVES])


def _leaf_grads_torch(scene_arrays, tc, tcfg):
    ts = scene_from_arrays(scene_arrays, CPU)
    leaves = [getattr(ts, k) for k in LEAVES] + [
        getattr(ts.lights, k) for k in LIGHT_LEAVES]
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = torch.mean(S.render_soft_tiled(ts, tc, tcfg)[..., :3] ** 2)
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize(
    "cam_kind,shading,shadows,atol",
    [("ortho", "phong", True, 1e-3), ("ortho", "lambert", False, 1e-3),
     ("pinhole", "phong", True, 2e-3)],
)
def test_soft_tiled_grads_match_jax(scenes, cam_kind, shading, shadows, atol):
    """The Function's backward (autograd of the twin, then of the gather)
    against jax.grad through the JAX custom_vjp, every leaf including the
    light position through the soft shadows."""
    js, _ = scenes
    jc, tc = _cameras(cam_kind)
    jcfg, tcfg = _cfgs(shading, shadows)
    want = _leaf_grads_jax(js, jc, jcfg)
    got = _leaf_grads_torch(scene_to_arrays(js), tc, tcfg)
    names = LEAVES + tuple(f"lights.{k}" for k in LIGHT_LEAVES)
    for name, a, b in zip(names, got, want):
        assert np.all(np.isfinite(a)), name
        assert not np.any((b != 0) & (a == 0)), f"{name}: zero where JAX is not"
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=atol, err_msg=name)
    assert np.any(got[5] != 0), "no light-position gradient"


def test_overflow_escalates_k():
    """40 overlapping spheres over the default cull_k. The port renders what
    JAX's `render_soft_tiled` renders at the same caps: its brute soft frame
    (every tile's list is cut at K, so `lax.cond` takes the brute kernels),
    through `render_soft_tiled` and `render_soft_pallas` alike; images
    within 0.05/255, every leaf's gradient within 1e-3 normalised. K
    escalates only where asked: `soft_bins_for_config`, the opt-in helper,
    re-bins up to K 40, and at cull_k 40 the port renders JAX's tiled frame.
    (The two frames differ: a culled sphere's ~1e-7 coverage costs its depth
    logit log(1e-7) = -16, but a sphere more than 16 tau_depth nearer still
    wins the softmin there, so JAX's own brute and tiled frames differ by
    more than 1e-4 on ~3% of this frame's pixels, by up to 130/255.)"""
    from opencl_ray_tracer_tpu_torch.kernels.soft import render_soft_pallas

    jp = J.random_scene(40, 0, seed=9, bounds=(60.0, 40.0))
    arrays = scene_to_arrays(jp)
    tp = scene_from_arrays(arrays, CPU)
    jcfg, tcfg = _cfgs("lambert", False)
    cam_j, cam_t = _cameras("ortho")
    assert bool(S._bin_soft(tp.pack(), 0.5, cam_t, height=H, width=W,
                            k=tcfg.cull_k, shadows=False,
                            shadow_k=tcfg.shadow_cull_k).overflow)
    bins = S.soft_bins_for_config(tp.pack(), cam_t, tcfg)
    assert not bool(bins.overflow) and bins.k_sph == 40

    want = np.asarray(jst.render_soft_tiled(jp, cam_j, jcfg, interpret=True))
    tiled40 = np.asarray(jst.render_soft_tiled(
        jp, cam_j, jcfg.replace(cull_k=40), interpret=True))
    assert (np.abs(want - tiled40).max(-1) > 1e-4).mean() > 0.01
    before = (tracing.counter("launch.B4"), tracing.counter("launch.B5"))
    for render in (S.render_soft_tiled, render_soft_pallas):
        with torch.no_grad():
            got = render(tp, cam_t, tcfg).numpy()
        assert np.isfinite(got).all() and (got[..., :3] > 1.0).any()
        assert np.abs(got - want).max() < 0.05, render.__name__
    with torch.no_grad():
        got40 = S.render_soft_tiled(tp, cam_t, tcfg.replace(cull_k=40)).numpy()
    assert np.abs(got40 - tiled40).max() < 0.05
    assert (tracing.counter("launch.B4"), tracing.counter("launch.B5")) == before  # CPU: the twins

    want_g = _leaf_grads_jax(jp, cam_j, jcfg)
    got_g = _leaf_grads_torch(arrays, cam_t, tcfg)
    names = LEAVES + tuple(f"lights.{k}" for k in LIGHT_LEAVES)
    for name, a, b in zip(names, got_g, want_g):
        assert np.all(np.isfinite(a)) and a.shape == b.shape, name
        if not b.size:  # the pile has no triangles
            continue
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-3, err_msg=name)
    assert np.any(got_g[0] != 0), "no sphere-origin gradient"


def test_saturation_tie_rule():
    """A coverage that saturates to exactly 1.0 (and one exactly 0) sits on a
    clip bound: JAX's clip splits the gradient evenly (1/2), and so must the
    twin's rank and background terms."""
    cov = np.array([[[1.0], [0.0], [0.5], [1e-13]]], np.float32)
    t = np.array([[[3.0], [2.0], [1.0], [4.0]]], np.float32)
    ctx_j = {"inv_td": jnp.float32(1.0)}

    def f_j(c, tt):
        return jnp.sum(jst._rank(tt, c, ctx_j)) + jnp.sum(jst._bacc_of(c[0]))

    gj = jax.grad(f_j, argnums=(0, 1))(jnp.asarray(cov), jnp.asarray(t))
    ct = torch.tensor(cov, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    ctx_t = {"inv_td": torch.tensor(1.0)}
    f_t = (torch.sum(S._rank(tt, ct, ctx_t))
           + torch.sum(S._log_unocc(ct)))
    gt = torch.autograd.grad(f_t, (ct, tt))
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # at c == 1: d log(clip(c, 1e-12, 1))/dc is 1/2, not 1 (the tie), and
    # the background's clip(c, 0, 1 - 1e-6) passes nothing
    assert gt[0][0, 0, 0].item() == 0.5


# ---- the backward's work list and gradient buffers -------------------------

RW, RH = 250, 123  # ragged right and bottom tiles


def _ragged_operands(ts):
    cfg = T.RenderConfig(width=RW, height=RH, shading="phong", shadows=True,
                         soft=True, framebuffer_dtype="float", tau_depth=1.0,
                         tau_edge=0.5)
    with torch.no_grad():
        return S.soft_kernel_inputs(ts.pack(), T.legacy_ortho_camera(device=CPU), cfg)


def _cotangent(kind):
    g = torch.zeros((RH, RW, 4))
    g[..., 3] = 3.0  # alpha's cotangent reaches nothing
    if kind == "scattered":
        g[3, 5, 1], g[77, 200, 0], g[RH - 1, RW - 1, 2] = 1.0, -2.0, 0.5
    elif kind == "patch":
        g[40:44, 96:104, :3] = 0.5
    elif kind == "dense":
        g[..., :3] = 1e-3
    return g


@pytest.mark.parametrize("kind", ["zero", "scattered", "patch", "dense"])
@pytest.mark.parametrize("empty_tile", [None, 3])
def test_live_patches_match_direct_mask(scenes, kind, empty_tile):
    """`_live_patches` against a walk over every patch of every tile: empty
    tiles excluded, patches cut by the frame's right and bottom edges kept
    where a pixel inside the frame has a cotangent, none for all zeros."""
    _, _, _, counts, kc = _ragged_operands(scenes[1])
    counts = counts.clone()
    if empty_tile is not None:
        counts[empty_tile, :2] = 0
    g = _cotangent(kind)
    nz = (g[..., :3] != 0).any(-1).numpy()
    want = []
    for tile in range(kc["nty"] * kc["ntx"]):
        if int(counts[tile, 0] + counts[tile, 1]) == 0:
            continue
        ty, tx = divmod(tile, kc["ntx"])
        for patch in range(256):
            y0 = ty * 64 + (patch // 16) * 4
            x0 = tx * 128 + (patch % 16) * 8
            if nz[y0:min(y0 + 4, RH), x0:min(x0 + 8, RW)].any():
                want.append(tile * 256 + patch)
    got = S._live_patches(g, counts, cfg=kc)
    assert got.dtype == torch.int64 and got.tolist() == want
    if kind == "zero":
        assert got.numel() == 0
    if kind == "scattered":
        # (3, 5): tile 0, patch 0; (77, 200) and (122, 249): tile 3, patches
        # (3, 9) and (14, 15) of its 16 x 16
        assert want == ([0, 3 * 256 + 57, 3 * 256 + 239] if empty_tile is None
                        else [0])
    if kind == "dense" and empty_tile is None:
        # 250 x 123: the right tiles' 122 columns of pixels reach into all 16
        # patch columns, the bottom tiles' 59 rows into 15 patch rows
        assert len(want) == 16 * 16 + 16 * 16 + 16 * 15 + 16 * 15


def test_soft_tiled_bwd_zero_cotangent_is_exactly_zero(scenes):
    params, taus, tables, counts, kc = _ragged_operands(scenes[1])
    grads = S.soft_tiled_bwd(params, taus, tables, counts, _cotangent("zero"),
                             cfg=kc)
    assert len(grads) == 8
    for t, gr in zip((params, taus) + tuple(tables), grads):
        assert gr.shape == t.shape and bool((gr == 0).all())


def test_soft_tiled_one_patch_cotangent_matches_jax(scenes):
    """The gradient of sum(img * g) for a cotangent g that is non-zero on
    one 8 x 4 patch only, every scene leaf, against JAX's tiled kernels in
    interpret mode."""
    js, _ = scenes
    jc, tc = _cameras("ortho")
    jcfg, tcfg = _cfgs("phong", True)
    g = np.zeros((H, W, 4), np.float32)
    g[40:44, 96:104, :3] = 0.5
    gj = jax.grad(lambda s: jnp.sum(
        jst.render_soft_tiled(s, jc, jcfg, interpret=True) * g))(js)
    want = ([np.asarray(getattr(gj, k)) for k in LEAVES]
            + [np.asarray(getattr(gj.lights, k)) for k in LIGHT_LEAVES])
    ts = scene_from_arrays(scene_to_arrays(js), CPU)
    leaves = [getattr(ts, k) for k in LEAVES] + [
        getattr(ts.lights, k) for k in LIGHT_LEAVES]
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = torch.sum(S.render_soft_tiled(ts, tc, tcfg) * torch.from_numpy(g))
    got = [a.numpy() for a in torch.autograd.grad(loss, leaves)]
    assert any(np.any(b != 0) for b in want)
    for name, a, b in zip(LEAVES + LIGHT_LEAVES, got, want):
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-3, err_msg=name)


def test_gradient_buffers_keep_shapes_and_do_not_alias(scenes):
    """The CUDA backward's outputs are views of one zeroed allocation:
    each has its input's shape, starts on a 16-byte boundary and overlaps no
    other; the Function's backward hands back one gradient per input."""
    params, taus, tables, counts, kc = _ragged_operands(scenes[1])
    inputs = (params, taus) + tuple(tables)
    grads = S._zero_grads(inputs)
    spans = []
    for t, gr in zip(inputs, grads):
        assert gr.shape == t.shape and gr.dtype == torch.float32
        assert gr.is_contiguous() and bool((gr == 0).all())
        assert gr.untyped_storage().data_ptr() == grads[0].untyped_storage().data_ptr()
        assert gr.storage_offset() % 4 == 0
        spans.append((gr.storage_offset(), gr.storage_offset() + gr.numel()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    for i, gr in enumerate(grads):  # a write to one shows in no other
        gr.fill_(float(i + 1))
    assert all(bool((gr == float(i + 1)).all()) for i, gr in enumerate(grads))

    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = S.SoftTiledFunction.apply(*leaves, counts, kc)
    got = torch.autograd.grad(out, leaves, _cotangent("patch"))
    for t, gr in zip(inputs, got):
        assert gr.shape == t.shape
    ptrs = [(gr.data_ptr(), gr.data_ptr() + 4 * gr.numel()) for gr in got]
    ptrs.sort()
    assert all(a[1] <= b[0] for a, b in zip(ptrs, ptrs[1:]))
