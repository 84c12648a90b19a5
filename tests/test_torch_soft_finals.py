"""Port parity: the stored-finals regime of the tiled soft pair
(kernels/soft_tiled.py) — B4 also writes each pixel's streaming finals into
a block, B5 reads them there in place of its recompute pass — against the
JAX package's `save_finals` / `res_tiles` (kernels/soft_tiled.py) in Pallas
interpret mode, with both regimes forced through `_FINALS_MIN_SLOTS`. On the
CPU the port's wrappers run the kernels' plain twin: the block as B4 writes
it, and B5's stored regime as the twin's autograd with the finals' values
taken from the block.

Bars: the stored regime's gradients within 1e-5 of the recompute regime's,
normalised by each leaf's largest (JAX's own bar, tests/test_soft_tiled.py),
and within 1e-3 (2e-3 pinhole) of JAX's stored regime (the port-vs-JAX bar of
tests/test_torch_soft_tiled.py); the image identical with and without the
block; each finals row within 1e-4 (2e-3 pinhole) of JAX's, normalised by the
row's largest magnitude over the written slots, bacc and the logvis rows
through exp (the background weight and each light's visibility, what the
finish reads: a sum of log1p(-x) at an x clipped to 1 - 1e-6 magnifies a
last-bit difference of x a million times), the visibilities within 1e-3
(the port-vs-JAX gradient bar: a shadow ray starts at the hit point, which
the finals give to their last bits, and a grazing occluder's sigmoids
magnify that).
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

torch.set_num_threads(2)

CPU = torch.device("cpu")
W, H = 256, 128  # 2x2 tiles
RW, RH = 250, 123  # ragged right and bottom tiles
PINHOLE = dict(position=(128.0, 64.0, 300.0), look_at=(128.0, 64.0, -85.0),
               fov_degrees=60.0, width=W, height=H)
LEAVES = ("sphere_origin", "sphere_radius", "sphere_colour", "tri_verts",
          "tri_colour")
LIGHT_LEAVES = ("position", "colour", "intensity", "ambient")
# the three cases of tests/test_soft_tiled.py's stored-finals test
CASES = [("phong", True, "ortho"),      # aggregate layout, shadows
         ("lambert", False, "ortho"),   # per-primitive layout
         ("phong", True, "pinhole")]    # projective, shared shadow tables


@pytest.fixture(scope="module")
def scenes():
    js = J.random_scene(5, 3, seed=4, bounds=(250.0, 120.0))
    return js, scene_from_arrays(scene_to_arrays(js), CPU)


def _cameras(kind):
    if kind == "ortho":
        return J.legacy_ortho_camera(), T.legacy_ortho_camera(device=CPU)
    return J.pinhole_camera(**PINHOLE), T.pinhole_camera(**PINHOLE, device=CPU)


def _cfgs(shading, shadows, w=W, h=H):
    kw = dict(width=w, height=h, shading=shading, shadows=shadows, soft=True,
              framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.5)
    return J.RenderConfig(**kw), T.RenderConfig(**kw)


def _force(monkeypatch, stored, jax_too=False):
    slots = 0 if stored else 1 << 30
    monkeypatch.setattr(S, "_FINALS_MIN_SLOTS", slots)
    if jax_too:
        monkeypatch.setattr(jst, "_FINALS_MIN_SLOTS", slots)


def _leaf_grads_torch(scene_arrays, tc, tcfg):
    ts = scene_from_arrays(scene_arrays, CPU)
    leaves = [getattr(ts, k) for k in LEAVES] + [
        getattr(ts.lights, k) for k in LIGHT_LEAVES]
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = torch.mean(S.render_soft_tiled(ts, tc, tcfg)[..., :3] ** 2)
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _leaf_grads_jax(js, jc, jcfg):
    g = jax.grad(lambda s: jnp.mean(
        jst.render_soft_tiled(s, jc, jcfg, interpret=True)[..., :3] ** 2))(js)
    return ([np.asarray(getattr(g, k)) for k in LEAVES]
            + [np.asarray(getattr(g.lights, k)) for k in LIGHT_LEAVES])


def _close(got, want, atol, what):
    names = LEAVES + tuple(f"lights.{k}" for k in LIGHT_LEAVES)
    for name, a, b in zip(names, got, want):
        assert np.all(np.isfinite(a)), f"{what}: {name}"
        if not b.size:
            continue
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=atol,
                                   err_msg=f"{what}: {name}")


# ---- (a) gradients: stored against recompute and against JAX's stored -------

@pytest.mark.parametrize("shading,shadows,cam_kind", CASES)
def test_stored_finals_grads_match_jax(scenes, monkeypatch, shading, shadows,
                                       cam_kind):
    """The port's stored-regime leaf gradients against its recompute regime
    (1e-5 normalised) and against the JAX package's stored regime, both
    forced on (1e-3, 2e-3 pinhole: the port-vs-JAX bar)."""
    js, _ = scenes
    jc, tc = _cameras(cam_kind)
    jcfg, tcfg = _cfgs(shading, shadows)
    arrays = scene_to_arrays(js)
    _force(monkeypatch, False)
    recompute = _leaf_grads_torch(arrays, tc, tcfg)
    _force(monkeypatch, True, jax_too=True)
    fwd_before = S.FWD_FINALS_LAUNCHES
    stored = _leaf_grads_torch(arrays, tc, tcfg)
    assert S.FWD_FINALS_LAUNCHES == fwd_before  # CPU: the twin
    _close(stored, recompute, 1e-5, "stored vs recompute")
    want = _leaf_grads_jax(js, jc, jcfg)
    _close(stored, want, 2e-3 if cam_kind == "pinhole" else 1e-3,
           "port stored vs JAX stored")
    assert np.any(stored[5] != 0) or not shadows, "no light-position gradient"


# ---- (b) the image does not change when the block is written ---------------

@pytest.mark.parametrize("shading,shadows,cam_kind", CASES)
def test_image_unchanged_by_the_block(scenes, monkeypatch, shading, shadows,
                                      cam_kind):
    _, ts = scenes
    _, tc = _cameras(cam_kind)
    _, tcfg = _cfgs(shading, shadows, RW, RH)
    with torch.no_grad():
        lean = S.render_soft_tiled(ts, tc, tcfg)
    _force(monkeypatch, True)
    params, taus, tables, counts, kc = S.soft_kernel_inputs(ts.pack(), tc, tcfg)
    assert kc["stored_finals"]
    leaves = [t.detach().requires_grad_(True) for t in (params, taus) + tables]
    img = S.SoftTiledFunction.apply(*leaves, counts, kc)
    assert torch.equal(img.detach(), lean)
    block = S.finals_block(kc, CPU)
    with torch.no_grad():
        img2 = S.soft_tiled_fwd(params, taus, tables, counts, cfg=kc,
                                finals=block)
    assert torch.equal(img2, lean)
    assert not block.isnan().all()


# ---- (c) the block's rows against JAX's residual block ---------------------

@pytest.mark.parametrize("shading,shadows,cam_kind", [
    ("phong", True, "ortho"), ("lambert", True, "ortho"),
    ("lambert", False, "ortho"), ("legacy", False, "ortho"),
    ("phong", False, "ortho"), ("phong", True, "pinhole")])
def test_finals_rows_match_jax_block(scenes, shading, shadows, cam_kind):
    """Each row of the plain block, by name through the layout map, against
    the row of JAX's `_soft_tiled_fwd_impl(..., save_finals=True)` block
    that holds the same quantity, on every slot the port writes (in-frame
    pixels of non-empty tiles; the others hold NaN): within 1e-4 of the
    row's largest magnitude (2e-3 through the pinhole camera, the port's
    pinhole bar against JAX: its rays are normalised per pixel, and torch's
    CPU sqrt is 1 ulp off IEEE on some inputs); bacc and logvis through exp
    (see the module's note).
    Lambert's colour sums are JAX's / 255. The logvis rows are held on the
    covered pixels (1 - w_bg != 0): at a pixel that nothing covers every
    weight is exp(0) over rows whose depth is about -1e9, so its hit point
    lies ~1e8 away and its log-visibility is a float32 artefact that differs
    from one formulation to the next (it reaches the gradient only times the
    candidates' coverages, each below 6e-8 there)."""
    js, ts = scenes
    jc, tc = _cameras(cam_kind)
    jcfg, tcfg = _cfgs(shading, shadows)
    jb = jst._bin_soft(js.pack(), jnp.float32(0.5), jc, height=H, width=W,
                       k=jcfg.cull_k, shadows=shadows,
                       shadow_k=jcfg.shadow_cull_k)
    _, fin = jst._soft_tiled_fwd_impl(
        js.pack(), jc, jnp.float32(1.0), jnp.float32(0.5), jb, height=H,
        width=W, shading=shading, shadows=shadows, interpret=True,
        save_finals=True)
    fin = np.asarray(fin)                                  # (n_tiles, R, TILE_PIX)
    with torch.no_grad():
        params, taus, tables, counts, kc = S.soft_kernel_inputs(
            ts.pack(), tc, tcfg)
        kc = dict(kc, stored_finals=True)
        _, block = S._soft_tiled_plain(params, taus, tables, counts, cfg=kc,
                                       want_finals=True)
    assert block.shape == (4, S.TILE_PATCHES, len(S.finals_layout(kc)), 32)
    planes = S._block_to_planes(block).numpy()             # (n_tiles, R, TILE_PIX)
    written = ~np.isnan(planes[:, 0])
    nonempty = (counts[:, 0] + counts[:, 1] > 0).numpy()
    assert written.any() and np.array_equal(written.any(1), nonempty)
    layout = S.finals_layout(kc)
    names = [n for n, _ in layout]
    covered = written & (1.0 - np.exp(planes[:, names.index("bacc")]) != 0)
    for i, (name, jrow) in enumerate(layout):
        want = fin[:, jrow]
        if shading == "lambert" and not shadows and name in ("sr", "sg", "sb"):
            want = want / 255.0
        mask = covered if name.startswith("logvis") else written
        got = planes[:, i][mask]
        want = want[mask]
        if name == "bacc" or name.startswith("logvis"):
            got, want = np.exp(got), np.exp(want)
        scale = np.abs(want).max() + 1e-30
        bar = 2e-3 if cam_kind == "pinhole" else 1e-4
        if name.startswith("logvis"):
            bar = max(bar, 1e-3)
        np.testing.assert_allclose(got / scale, want / scale, atol=bar,
                                   err_msg=f"{shading} {shadows} {cam_kind}: {name}")


def test_finals_layout_rows():
    agg = S.finals_layout(dict(shading="phong", shadows=True, n_lights=2))
    assert [n for n, _ in agg] == (
        ["m", "z", "st"] + [f"s8[{a}]" for a in range(6)]
        + ["snx", "sny", "snz", "bacc", "logvis[0]", "logvis[1]"])
    assert [j for _, j in agg] == list(range(9)) + [11, 12, 13, 14, 15, 16]
    assert len(S.finals_layout(dict(shading="phong", shadows=False, n_lights=3))) == 13
    assert len(S.finals_layout(dict(shading="lambert", shadows=True, n_lights=1))) == 14
    for shading in ("legacy", "lambert"):
        flat = S.finals_layout(dict(shading=shading, shadows=False, n_lights=1))
        assert flat == (("m", 0), ("z", 1), ("sr", 2), ("sg", 3), ("sb", 4),
                        ("bacc", 5))
    assert len(S.finals_layout(dict(shading="legacy", shadows=True, n_lights=2))) == 6


def test_block_layout_is_patch_major():
    """Pixel (x, y) of a tile lands in patch 16 * (y // 4) + x // 8, lane
    8 * (y % 4) + x % 8, and the two conversions are inverse."""
    planes = torch.arange(2 * 3 * S.TILE_PIX, dtype=torch.float32).reshape(
        2, 3, S.TILE_PIX)
    block = S._planes_to_block(planes)
    assert block.shape == (2, S.TILE_PATCHES, 3, 32)
    for x, y in ((0, 0), (7, 3), (8, 0), (127, 63), (37, 22)):
        p = y * 128 + x
        assert block[1, 16 * (y // 4) + x // 8, 2, 8 * (y % 4) + x % 8] == planes[1, 2, p]
    assert torch.equal(S._block_to_planes(block), planes)


# ---- (d) the gate: JAX's slot counts on the bench's three configurations ----

@pytest.mark.parametrize("name,n_sph,n_cube,seed,k,shadow_k,slots", [
    ("headline", 10, 1, 0, 32, 64, 64),
    ("50 + 4", 50, 4, 1, 32, 64, 168),
    # 96 + 96 + 136 + 104: 100 spheres round to 104 shadow slots, not 136
    ("stress", 100, 100, 0, 96, 136, 432),
])
def test_use_stored_finals_counts_jax_slots(monkeypatch, name, n_sph, n_cube,
                                           seed, k, shadow_k, slots):
    """The bench's 1920x1080 soft configurations (bench.py): the port's bins
    have JAX's K caps, so the slot count is JAX's, and at the same threshold
    the two gates agree."""
    w, h = 1920, 1080
    js = J.random_scene(n_sph, n_cube, seed=seed, bounds=(w - 10.0, h - 10.0))
    ts = scene_from_arrays(scene_to_arrays(js), CPU)
    jb = jst._bin_soft(js.pack(), jnp.float32(0.5), J.legacy_ortho_camera(),
                       height=h, width=w, k=k, shadows=True, shadow_k=shadow_k)
    tb = S._bin_soft(ts.pack(), 0.5, T.legacy_ortho_camera(device=CPU),
                     height=h, width=w, k=k, shadows=True, shadow_k=shadow_k)
    for f in ("k_tri", "k_sph", "k_sh_tri", "k_sh_sph"):
        assert getattr(tb, f) == getattr(jb, f), f
    assert S._finals_slots(tb, 1, True) == slots
    assert S._finals_slots(tb, 1, False) == tb.k_tri + tb.k_sph
    for threshold in (64, 65, 128, 168, 169, 464, 465):
        monkeypatch.setattr(S, "_FINALS_MIN_SLOTS", threshold)
        monkeypatch.setattr(jst, "_FINALS_MIN_SLOTS", threshold)
        for shadows in (True, False):
            assert (S._use_stored_finals(tb, 1, shadows)
                    == jst._use_stored_finals(jb, 1, shadows)), (threshold, shadows)


# ---- (e) the plain backward reads the block --------------------------------

@pytest.mark.parametrize("shading,shadows,row", [
    ("phong", True, "z"), ("phong", True, "logvis[0]"), ("phong", True, "m"),
    ("lambert", False, "sg"), ("legacy", False, "bacc")])
def test_corrupted_block_changes_plain_gradients(scenes, shading, shadows, row):
    """The plain stored backward takes the finals' values from the block: a
    block whose row is changed changes the gradients, and the block as B4
    wrote it gives the recompute regime's gradients exactly, for a
    cotangent on every pixel (the uncovered ones walk their occluders)."""
    _, ts = scenes
    _, tcfg = _cfgs(shading, shadows, RW, RH)
    with torch.no_grad():
        params, taus, tables, counts, kc = S.soft_kernel_inputs(
            ts.pack(), T.legacy_ortho_camera(device=CPU), tcfg)
    kc = dict(kc, stored_finals=True)
    block = S.finals_block(kc, CPU)
    img = S.soft_tiled_fwd(params, taus, tables, counts, cfg=kc, finals=block)
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal((RH, RW, 4)).astype(np.float32))
    assert bool((img[..., :3] == 0).all(-1).any())  # some pixels uncovered
    base = S.soft_tiled_bwd(params, taus, tables, counts, g, cfg=kc)
    same = S.soft_tiled_bwd(params, taus, tables, counts, g, cfg=kc,
                            finals=block)
    for a, b in zip(same, base):
        assert torch.equal(a, b)
    bad = block.clone()
    i = [n for n, _ in S.finals_layout(kc)].index(row)
    bad[:, :, i] = bad[:, :, i] + 0.5 if row == "m" else bad[:, :, i] * 1.5 + 0.25
    moved = S.soft_tiled_bwd(params, taus, tables, counts, g, cfg=kc,
                             finals=bad)
    diff = max(float((a - b).abs().max()) for a, b in zip(moved, base))
    assert diff > 1e-3 * max(float(b.abs().max()) for b in base), row
    assert all(bool(torch.isfinite(a).all()) for a in moved)


# ---- no fallback: what the wrappers refuse ----------------------------------

def test_wrappers_refuse_a_bad_block(scenes, monkeypatch):
    _, ts = scenes
    _, tcfg = _cfgs("phong", True, RW, RH)
    _force(monkeypatch, False)
    with torch.no_grad():
        params, taus, tables, counts, kc = S.soft_kernel_inputs(
            ts.pack(), T.legacy_ortho_camera(device=CPU), tcfg)
    assert not kc["stored_finals"]
    g = torch.ones((RH, RW, 4))
    block = S.finals_block(dict(kc, stored_finals=True), CPU)
    with pytest.raises(ValueError, match="recompute"):
        S.soft_tiled_fwd(params, taus, tables, counts, cfg=kc, finals=block)
    with pytest.raises(ValueError, match="recompute"):
        S.soft_tiled_bwd(params, taus, tables, counts, g, cfg=kc, finals=block)
    kc = dict(kc, stored_finals=True)
    for bad, err in ((block[:, :, :-1].contiguous(), ValueError),
                     (block.double(), TypeError),
                     (block.to("meta"), ValueError),
                     (block.transpose(2, 3).contiguous().transpose(2, 3), ValueError)):
        with pytest.raises(err):
            S.soft_tiled_fwd(params, taus, tables, counts, cfg=kc, finals=bad)
        with pytest.raises(err):
            S.soft_tiled_bwd(params, taus, tables, counts, g, cfg=kc, finals=bad)


def test_function_writes_the_block_only_for_a_gradient(scenes, monkeypatch):
    """SoftTiledFunction allocates and writes the block only where the gate
    says stored and an input wants a gradient (JAX's inference forward stays
    lean), and hands it to the backward."""
    _, ts = scenes
    _, tcfg = _cfgs("phong", True, RW, RH)
    _force(monkeypatch, True)
    params, taus, tables, counts, kc = S.soft_kernel_inputs(
        ts.pack(), T.legacy_ortho_camera(device=CPU), tcfg)
    seen = []
    real_bwd = S.soft_tiled_bwd

    def spy(*a, finals=None, **k):
        seen.append(finals)
        return real_bwd(*a, finals=finals, **k)

    monkeypatch.setattr(S, "soft_tiled_bwd", spy)
    real_fwd = S.soft_tiled_fwd
    made = []

    def spy_fwd(*a, finals=None, **k):
        made.append(finals)
        return real_fwd(*a, finals=finals, **k)

    monkeypatch.setattr(S, "soft_tiled_fwd", spy_fwd)
    detached = [t.detach() for t in (params, taus) + tables]
    S.SoftTiledFunction.apply(*detached, counts, kc)
    assert made[-1] is None
    leaves = [t.requires_grad_(True) for t in detached]
    img = S.SoftTiledFunction.apply(*leaves, counts, kc)
    assert made[-1] is not None and made[-1].shape[2] == 14
    img.sum().backward()
    assert seen and seen[-1] is made[-1]


# ---- the compiled path's autograd node (`_soft_tiled_core`) ----------------

@pytest.mark.parametrize("k", [40, 32])
def test_soft_core_stored_finals_matches_recompute(monkeypatch, k):
    """`_soft_tiled_core` on the 40-sphere pile of
    tests/test_torch_soft_tiled.py::test_overflow_escalates_k: at K 40 no
    list overflows and the tiled branch runs, at K 32 the brute branch is
    taken (on the CPU both branches run and torch.where selects). The block
    is allocated before the cond, the tiled branches write and read it; the
    image is identical and the leaf gradients within 1e-5 (normalised) of
    the recompute regime's, in both cases."""
    from opencl_ray_tracer_tpu_torch.parallel.train import (
        scene_leaves,
        trainable_scene,
    )

    jp = J.random_scene(40, 0, seed=9, bounds=(60.0, 40.0))
    cam = T.legacy_ortho_camera(device=CPU)
    made = []
    real = S.finals_block
    monkeypatch.setattr(S, "finals_block",
                        lambda cfg, dev: made.append(cfg) or real(cfg, dev))

    def run(stored):
        _force(monkeypatch, stored)
        s = trainable_scene(scene_from_arrays(scene_to_arrays(jp), CPU))
        leaves = scene_leaves(s)
        img = S._soft_tiled_core(s.pack(), cam, 1.0, 0.5, H, W, "phong", True,
                                 k, 64)
        grads = torch.autograd.grad((img[..., :3] ** 2).mean(),
                                    list(leaves.values()), allow_unused=True)
        return img.detach(), [torch.zeros_like(v) if g is None else g
                              for v, g in zip(leaves.values(), grads)]

    img_r, g_r = run(False)
    assert not made
    img_s, g_s = run(True)
    assert len(made) == 1
    assert torch.equal(img_s, img_r)
    for a, b in zip(g_s, g_r):
        assert torch.isfinite(a).all()
        if not b.numel():  # the pile has no triangles
            continue
        scale = float(b.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= 1e-5 * scale
