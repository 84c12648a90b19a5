"""The CUDA tiled kernel against its plain torch twin, on the card.

These need an NVIDIA card and nvcc (the kernel has no CPU mode), so they
skip where torch.cuda.is_available() is false. Run them on the card with:

    python -m pytest tests/test_torch_kernels_gpu.py -q

Bars, on every pixel: float frames within 0.5/255 of the twin, packed words
within one step of 1/255 per channel (a value that lands on a rounding edge
can round the other way when the two sides differ in the last ulp) and
identical on >= 99.5% of pixels. On an H100 the largest differences read
0.22 (float) and 1 (packed).
"""

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
from opencl_ray_tracer_tpu_torch.utils import tracing, unpack_words

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

pytestmark = pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs an NVIDIA card: the CUDA kernel has no CPU mode")

W, H = 640, 480


@pytest.fixture(scope="module")
def cuda_device():
    return torch.device("cuda")


def _inputs(device, scene_num, cam_kind, shading, shadows, fmt):
    scene = T.create_scene(scene_num, seed=0, device=device)
    if cam_kind == "ortho":
        cam = T.legacy_ortho_camera(device=device)
    else:
        cam = T.pinhole_camera((320.0, 240.0, 60.0), (320.0, 240.0, -85.0),
                               fov_degrees=80.0, width=W, height=H,
                               device=device)
    cfg = T.RenderConfig(width=W, height=H, shading=shading, shadows=shadows,
                         framebuffer_dtype=fmt)
    packed = scene.pack()
    bins = fwd_tiled.bin_for_config(packed, cam, cfg)
    return fwd_tiled.kernel_inputs(packed, cam, bins, height=H, width=W,
                                   shading=shading, shadows=shadows,
                                   out_format=fmt)


@pytest.mark.parametrize(
    "scene_num,cam_kind,shading,shadows,fmt",
    [
        (1, "ortho", "legacy", False, "packed"),
        (1, "ortho", "phong", True, "float"),
        (2, "ortho", "lambert", True, "packed"),
        (2, "pinhole", "phong", True, "float"),
        (3, "ortho", "phong", True, "packed"),
        (3, "pinhole", "legacy", False, "float"),
    ],
)
def test_kernel_matches_twin(cuda_device, scene_num, cam_kind, shading,
                             shadows, fmt):
    args, kw = _inputs(cuda_device, scene_num, cam_kind, shading, shadows, fmt)
    before = tracing.counter("launch.B1")
    got = fwd_tiled.tiled_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert tracing.counter("launch.B1") == before + 1
    want = fwd_tiled._tiled_kernel_plain(*args, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    if fmt == "packed":
        err = np.abs(unpack_words(got).astype(np.int32)
                     - unpack_words(want).astype(np.int32)).max(axis=-1)
        assert err.max() <= 1, f"packed byte error {err.max()} > 1"
        frac = (err == 0).mean()
        assert frac >= 0.995, f"only {frac:.4%} of pixels identical"
    else:
        err = (got - want).abs().max().item()
        assert err < 0.5, f"float error {err} >= 0.5"


def test_wrapper_rejects_bad_inputs(cuda_device):
    args, kw = _inputs(cuda_device, 1, "ortho", "legacy", False, "packed")
    bad = list(args)
    bad[1] = args[1].to(torch.int64)
    with pytest.raises(TypeError):
        fwd_tiled.tiled_kernel(*bad, **kw)
    bad = list(args)
    bad[2] = args[2].transpose(0, 1)
    with pytest.raises(ValueError):
        fwd_tiled.tiled_kernel(*bad, **kw)
    with pytest.raises(ValueError):
        fwd_tiled.tiled_kernel(*args, **{**kw, "width": W + 256})


# B1/B2 launch blocks only for the tiles that the card lists as non-empty
# (the empty ones are filled with the background): a frame with no
# candidate, a frame whose every tile holds candidates (scene 3), and a
# 100x70 frame, which is not a whole tile.
def _tile_list_scene(device, kind):
    import dataclasses

    if kind == "full":
        return T.create_scene(3, seed=0, device=device), W, H
    scene = T.create_scene1(device=device)
    if kind == "empty":  # every primitive beyond the frame's right edge
        shift = torch.tensor([5000.0, 0.0, 0.0], device=device)
        scene = dataclasses.replace(scene, sphere_origin=scene.sphere_origin + shift,
                                    tri_verts=scene.tri_verts + shift)
        return scene, W, H
    return scene, 100, 70


def _assert_list(tiles, counts):
    want = fwd_tiled._live_tiles(counts)
    assert tiles[0].item() == want.numel()
    assert torch.equal(tiles[2:2 + want.numel()].sort().values.long(), want)


@pytest.mark.parametrize("kind", ["empty", "full", "ragged"])
@pytest.mark.parametrize("cam_kind,shading,shadows,fmt",
                         [("ortho", "phong", True, "packed"),
                          ("ortho", "phong", True, "float"),
                          ("pinhole", "legacy", False, "packed")])
def test_kernel_tile_list(cuda_device, kind, cam_kind, shading, shadows, fmt):
    scene, w, h = _tile_list_scene(cuda_device, kind)
    cam = (T.legacy_ortho_camera(device=cuda_device) if cam_kind == "ortho" else
           T.pinhole_camera((w / 2.0, h / 2.0, 60.0), (w / 2.0, h / 2.0, -85.0),
                            fov_degrees=80.0, width=w, height=h, device=cuda_device))
    cfg = T.RenderConfig(width=w, height=h, shading=shading, shadows=shadows,
                         framebuffer_dtype=fmt)
    packed = scene.pack()
    bins = fwd_tiled.bin_for_config(packed, cam, cfg)
    args, kw = fwd_tiled.kernel_inputs(packed, cam, bins, height=h, width=w,
                                       shading=shading, shadows=shadows,
                                       out_format=fmt)
    got, tiles = fwd_tiled._tiled_kernel_cuda(*args, **kw)
    torch.cuda.synchronize()
    _assert_list(tiles, args[1])
    n_live = tiles[0].item()
    if kind == "empty":
        assert n_live == 0
    if kind == "full":
        assert n_live == args[1].shape[0]
    want = fwd_tiled._tiled_kernel_plain(*args, **kw)
    if fmt == "packed":
        err = np.abs(unpack_words(got).astype(np.int32)
                     - unpack_words(want).astype(np.int32)).max(axis=-1)
        assert err.max() <= 1 and (err == 0).mean() >= 0.995
        if kind == "empty":
            assert bool((got == -16777216).all())  # 0xFF000000
    else:
        assert (got - want).abs().max().item() < 0.5
        if kind == "empty":
            bg = torch.tensor([0.0, 0.0, 0.0, 255.0], device=cuda_device)
            assert bool((got == bg).all())


# Tables wider than the 48 KB in which B1/B2 stage a tile's rows: scene 3
# with two lights (128 + 104 candidates and 512 + 208 occluders a tile, 60
# KB) reads them through L1.
@pytest.mark.parametrize("fmt", ["packed", "float"])
def test_kernel_rows_through_l1(cuda_device, fmt):
    import dataclasses

    scene = T.create_scene(3, seed=0, device=cuda_device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=cuda_device)  # noqa: E731
    scene = dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, position=f32([[200.0, 100.0, 200.0], [250.0, 10.0, 180.0]]),
        colour=f32([[1.0, 1.0, 1.0], [1.0, 0.6, 0.3]]), intensity=f32([1.0, 0.5])))
    cam = T.legacy_ortho_camera(device=cuda_device)
    cfg = T.RenderConfig(width=W, height=H, shading="phong", shadows=True,
                         framebuffer_dtype=fmt)
    packed = scene.pack()
    bins = fwd_tiled.bin_for_config(packed, cam, cfg)
    args, kw = fwd_tiled.kernel_inputs(packed, cam, bins, height=H, width=W,
                                       shading="phong", shadows=True, out_format=fmt)
    rows = sum(args[i].shape[1] for i in (2, 4, 6, 7))
    assert rows * 64 > 48 * 1024
    got, tiles = fwd_tiled._tiled_kernel_cuda(*args, **kw)
    torch.cuda.synchronize()
    _assert_list(tiles, args[1])
    want = fwd_tiled._tiled_kernel_plain(*args, **kw)
    if fmt == "packed":
        err = np.abs(unpack_words(got).astype(np.int32)
                     - unpack_words(want).astype(np.int32)).max(axis=-1)
        assert err.max() <= 1 and (err == 0).mean() >= 0.995
    else:
        assert (got - want).abs().max().item() < 0.5


def _assert_twin(got, want, fmt):
    if fmt == "packed":
        err = np.abs(unpack_words(got).astype(np.int32)
                     - unpack_words(want).astype(np.int32)).max(axis=-1)
        assert err.max() <= 1 and (err == 0).mean() >= 0.995
    else:
        assert (got - want).abs().max().item() < 0.5


# The bench's 4K frame (random_scene(100, 100, seed=2), cull_k=96): 1,020
# tiles, where every other card frame has at most 255; the card's list of
# non-empty tiles against its plain version, every pixel against the twin.
@pytest.mark.parametrize("shading,shadows,fmt", [("legacy", False, "packed"),
                                                 ("phong", True, "float")])
def test_kernel_4k_tile_list(cuda_device, shading, shadows, fmt):
    w, h = 3840, 2160
    scene = T.random_scene(100, 100, seed=2, bounds=(w - 10.0, h - 10.0),
                           device=cuda_device)
    cam = T.legacy_ortho_camera(device=cuda_device)
    cfg = T.RenderConfig(width=w, height=h, shading=shading, shadows=shadows,
                         cull_k=96, framebuffer_dtype=fmt)
    packed = scene.pack()
    bins = fwd_tiled.bin_for_config(packed, cam, cfg)
    args, kw = fwd_tiled.kernel_inputs(packed, cam, bins, height=h, width=w,
                                       shading=shading, shadows=shadows,
                                       out_format=fmt)
    assert args[1].shape[0] == 1020
    got, tiles = fwd_tiled._tiled_kernel_cuda(*args, **kw)
    torch.cuda.synchronize()
    _assert_list(tiles, args[1])
    assert tiles[0].item() > 255
    _assert_twin(got, fwd_tiled._tiled_kernel_plain(*args, **kw), fmt)


# The stress scene (random_scene(100, 100, seed=0) at 1080p) from K caps of
# 16: the lists overflow and the port re-bins with both caps doubled; B1/B2
# and B4 then run on the wider tables, held against their twins.
@pytest.mark.parametrize("shading,shadows,fmt", [("legacy", False, "packed"),
                                                 ("phong", True, "float")])
def test_kernel_stress_k_escalation(cuda_device, shading, shadows, fmt):
    w, h = 1920, 1080
    scene = T.random_scene(100, 100, seed=0, bounds=(w - 10.0, h - 10.0),
                           device=cuda_device)
    cam = T.legacy_ortho_camera(device=cuda_device)
    cfg = T.RenderConfig(width=w, height=h, shading=shading, shadows=shadows,
                         cull_k=16, shadow_cull_k=16, framebuffer_dtype=fmt)
    packed = scene.pack()
    bins = fwd_tiled.bin_for_config(packed, cam, cfg)
    assert max(bins.k_tri, bins.k_sph) > 16 and not bool(bins.overflow)
    args, kw = fwd_tiled.kernel_inputs(packed, cam, bins, height=h, width=w,
                                       shading=shading, shadows=shadows,
                                       out_format=fmt)
    got, tiles = fwd_tiled._tiled_kernel_cuda(*args, **kw)
    torch.cuda.synchronize()
    _assert_list(tiles, args[1])
    _assert_twin(got, fwd_tiled._tiled_kernel_plain(*args, **kw), fmt)
    # the whole path re-bins the same way: its frame is the kernel's
    assert torch.equal(fwd_tiled.render_tiled_packed(packed, cam, cfg), got)


def test_soft_tiled_fwd_stress_k_escalation(cuda_device):
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S

    scene = T.random_scene(100, 100, seed=0, bounds=(1910.0, 1070.0),
                           device=cuda_device)
    cam = T.legacy_ortho_camera(device=cuda_device)
    cfg = T.RenderConfig(width=640, height=480, shading="phong", shadows=True,
                         soft=True, framebuffer_dtype="float", tau_depth=1.0,
                         tau_edge=0.5, cull_k=8, shadow_cull_k=8)
    bins = S.soft_bins_for_config(scene.pack(), cam, cfg)
    assert max(bins.k_tri, bins.k_sph) > 8 and not bool(bins.overflow)
    with torch.no_grad():
        params, taus, tables, counts, kc = S.soft_kernel_inputs(scene.pack(), cam, cfg)
        assert tables[0].shape[1] == bins.k_tri
        got, tiles = S._soft_tiled_fwd_cuda(params, taus, tables, counts, kc)
        torch.cuda.synchronize()
        _assert_list(tiles, counts)
        want = S._soft_tiled_plain(params, taus, tables, counts, cfg=kc)
    assert (got[..., :3] != 0).any()
    assert (got - want).abs().max().item() < 0.05


# ---- the soft kernels B4 (forward) and B5 (backward) ----------------------
# Bars (chip_smoke.py phase 7): images within 0.05/255 on every pixel; every
# scene leaf's gradient of mean(img[..., :3]**2) within 1e-3 of the twin's,
# normalised by the twin's largest (2e-3 pinhole), and non-zero where the
# twin's is; pixel-gradient Jacobian rows within 1e-4 of the twin's and of
# diff.render_soft's.

SOFT_W, SOFT_H = 256, 128
SOFT_PINHOLE = dict(position=(128.0, 64.0, 200.0), look_at=(128.0, 64.0, -60.0),
                    fov_degrees=65.0, width=SOFT_W, height=SOFT_H)


def _soft_case(device, scene_name, cam_kind, shading, shadows):
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S

    def lights(n):  # n point lights of different colours around the volume
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
        return T.Lights(
            position=f32([[200.0, 100.0, 200.0], [250.0, 10.0, 180.0],
                          [130.0, -40.0, 120.0]][:n]),
            colour=f32([[1.0, 1.0, 1.0], [1.0, 0.6, 0.3], [0.3, 0.5, 1.0]][:n]),
            intensity=f32([1.0, 0.5, 0.5][:n]), ambient=f32(0.1),
            spec_strength=f32(0.5), shininess=f32(32.0))

    scene = {"test": lambda: T.random_scene(5, 3, seed=4, bounds=(250.0, 120.0),
                                            device=device),
             "two_lights": lambda: T.random_scene(
                 5, 3, seed=4, bounds=(250.0, 120.0), lights=lights(2), device=device),
             "three_lights": lambda: T.random_scene(
                 5, 3, seed=4, bounds=(250.0, 120.0), lights=lights(3), device=device),
             "scene1": lambda: T.create_scene1(device=device),
             "scene3": lambda: T.create_scene(3, seed=0, device=device),
             "big": lambda: T.random_scene(200, 200, seed=1, bounds=(250.0, 120.0),
                                           device=device)}[scene_name]()
    cam = (T.legacy_ortho_camera(device=device) if cam_kind == "ortho"
           else T.pinhole_camera(**SOFT_PINHOLE, device=device))
    cfg = T.RenderConfig(width=SOFT_W, height=SOFT_H, shading=shading,
                         shadows=shadows, soft=True, framebuffer_dtype="float",
                         tau_depth=1.0, tau_edge=0.5)
    return S, scene, cam, cfg


def _soft_grads(render, scene, cam, cfg):
    from opencl_ray_tracer_tpu_torch.parallel.train import (
        scene_leaves,
        trainable_scene,
    )

    s = trainable_scene(scene)
    leaves = scene_leaves(s)
    loss = (render(s, cam, cfg)[..., :3] ** 2).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), grads)}


def _twin(s, c, f):
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S

    params, taus, tables, counts, kc = S.soft_kernel_inputs(s.pack(), c, f)
    return S._soft_tiled_plain(params, taus, tables, counts, cfg=kc)


@pytest.mark.parametrize("scene_name", ["test", "scene1"])
@pytest.mark.parametrize("cam_kind", ["ortho", "pinhole"])
@pytest.mark.parametrize("shading,shadows", [("legacy", False),
                                             ("lambert", False),
                                             ("lambert", True),
                                             ("phong", True)])
def test_soft_kernels_match_twin(cuda_device, scene_name, cam_kind, shading,
                                 shadows):
    S, scene, cam, cfg = _soft_case(cuda_device, scene_name, cam_kind,
                                    shading, shadows)
    before = (tracing.counter("launch.B4"), tracing.counter("launch.B5"))
    with torch.no_grad():
        got = S.render_soft_tiled(scene, cam, cfg)
        want = _twin(scene, cam, cfg)
    assert (got - want).abs().max().item() < 0.05
    gk = _soft_grads(S.render_soft_tiled, scene, cam, cfg)
    gt = _soft_grads(_twin, scene, cam, cfg)
    assert (tracing.counter("launch.B4") > before[0]
            and tracing.counter("launch.B5") > before[1])
    atol = 1e-3 if cam_kind == "ortho" else 2e-3
    for k, w in gt.items():
        g = gk[k]
        assert torch.isfinite(g).all(), k
        scale = w.abs().max().item()
        if scale == 0.0:
            assert g.abs().max().item() == 0.0, k
            continue
        assert (g - w).abs().max().item() / scale <= atol, k
        assert not ((w.abs() > 1e-6 * scale) & (g == 0)).any(), k


# edge pixels whose rows reach the triangles and every light leaf
@pytest.mark.parametrize("yy,xx,c", [(25, 117, 2), (52, 179, 1), (60, 50, 0),
                                     (93, 163, 2)])
def test_soft_pixel_gradient_probes(cuda_device, yy, xx, c):
    """Jacobian rows d(pixel / 255)/d(scene leaves) of scene 1, phong +
    soft shadows: the kernels against the twin and the diff.render_soft
    oracle, max-abs within 1e-4 (the pixel-gradient bar of BASELINE.md)."""
    from opencl_ray_tracer_tpu_torch.diff import render_soft

    S, scene, cam, cfg = _soft_case(cuda_device, "scene1", "ortho", "phong", True)

    def row(render):
        from opencl_ray_tracer_tpu_torch.parallel.train import (
            scene_leaves,
            trainable_scene,
        )

        s = trainable_scene(scene)
        leaves = scene_leaves(s)
        px = render(s, cam, cfg)[yy, xx, c] / 255.0
        grads = torch.autograd.grad(px, list(leaves.values()), allow_unused=True)
        return [torch.zeros_like(v) if g is None else g
                for v, g in zip(leaves.values(), grads)]

    got = row(S.render_soft_tiled)
    for want in (row(_twin), row(render_soft)):
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        assert err <= 1e-4, err


# B4 launches blocks only for the tiles that the card lists as non-empty:
# a frame with no candidate, every tile live (scene 3 at 640x480), a 100x70
# frame, and two and three lights (the build that reads the light count at
# run time; one light has a build of its own).
@pytest.mark.parametrize("scene_name,kind,shading,shadows",
                         [("test", "empty", "phong", True),
                          ("scene3", "full", "phong", True),
                          ("test", "ragged", "phong", True),
                          ("test", "ragged", "legacy", False),
                          ("two_lights", "ragged", "phong", True),
                          ("three_lights", "ragged", "lambert", True)])
def test_soft_tiled_fwd_tile_list(cuda_device, scene_name, kind, shading, shadows):
    import dataclasses

    S, scene, cam, cfg = _soft_case(cuda_device, scene_name, "ortho", shading,
                                    shadows)
    w, h = {"empty": (SOFT_W, SOFT_H), "full": (640, 480), "ragged": (100, 70)}[kind]
    cfg = cfg.replace(width=w, height=h)
    if kind == "empty":  # every primitive beyond the frame's right edge
        shift = torch.tensor([5000.0, 0.0, 0.0], device=cuda_device)
        scene = dataclasses.replace(scene, sphere_origin=scene.sphere_origin + shift,
                                    tri_verts=scene.tri_verts + shift)
    with torch.no_grad():
        params, taus, tables, counts, kc = S.soft_kernel_inputs(scene.pack(), cam, cfg)
        before = tracing.counter("launch.B4")
        got, tiles = S._soft_tiled_fwd_cuda(params, taus, tables, counts, kc)
        torch.cuda.synchronize()
        assert tracing.counter("launch.B4") == before + 1
        _assert_list(tiles, counts)
        if kind == "empty":
            bg = torch.tensor([0.0, 0.0, 0.0, 255.0], device=cuda_device)
            assert tiles[0].item() == 0 and bool((got == bg).all())
            return
        if kind == "full":
            assert tiles[0].item() == counts.shape[0]
        want = S._soft_tiled_plain(params, taus, tables, counts, cfg=kc)
    assert (got[..., :3] != 0).any(), "the camera sees nothing"
    assert (got - want).abs().max().item() < 0.05


# B5 and its cotangent (250x123: ragged right and bottom tiles): it walks
# only the patches of non-empty tiles that hold a non-zero cotangent, whose
# list the card builds; exact zeros for an all-zero cotangent; two and three
# lights run the build that reads the light count at run time.
@pytest.mark.parametrize(
    "scene_name,shading,shadows,cotangent",
    [("test", "phong", True, kind)
     for kind in ("zero", "scattered", "patch", "dense")]
    + [("two_lights", "phong", True, "dense"),
       ("three_lights", "lambert", True, "scattered"),
       ("scene3", "phong", True, "dense")])
def test_soft_tiled_bwd_cotangents(cuda_device, scene_name, shading, shadows,
                                   cotangent):
    S, scene, cam, cfg = _soft_case(cuda_device, scene_name, "ortho", shading,
                                    shadows)
    w, h = 250, 123
    cfg = cfg.replace(width=w, height=h)
    with torch.no_grad():
        params, taus, tables, counts, kc = S.soft_kernel_inputs(scene.pack(), cam, cfg)
    g = torch.zeros((h, w, 4), device=cuda_device)
    g[..., 3] = 2.0  # alpha's cotangent reaches nothing
    if cotangent == "scattered":
        g[3, 5, 1], g[77, 200, 0], g[h - 1, w - 1, 2] = 1.0, -2.0, 0.5
    elif cotangent == "patch":
        g[40:44, 96:104, :3] = 0.5
    elif cotangent == "dense":
        g[..., :3] = 1e-3
    before = tracing.counter("launch.B5")
    inputs = (params, taus) + tuple(tables)
    got, live = S._soft_tiled_bwd_cuda(params, taus, tables, counts, g, kc)
    torch.cuda.synchronize()
    assert tracing.counter("launch.B5") == before + 1
    want_live = S._live_patches(g, counts, cfg=kc)
    assert live[0].item() == want_live.numel()
    assert torch.equal(live[2:2 + want_live.numel()].sort().values.long(), want_live)
    for t, gr in zip(inputs, got):  # views of one buffer: shapes kept, no overlap
        assert gr.shape == t.shape and gr.is_contiguous()
    spans = sorted((gr.data_ptr(), gr.data_ptr() + 4 * gr.numel()) for gr in got)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    if cotangent == "zero":
        assert all(bool((a == 0).all()) for a in got)
        return
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = S._soft_tiled_plain(leaves[0], leaves[1], leaves[2:], counts, cfg=kc)
    want = torch.autograd.grad(out, leaves, g, allow_unused=True)
    for name, a, b in zip(("params", "taus", "tri_t", "tri_alb", "sph_t",
                           "sph_alb", "tsh_t", "ssh_t"), got, want):
        b = torch.zeros_like(a) if b is None else b
        assert torch.isfinite(a).all(), name
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-3 * scale + 1e-12, name


# ---- the stored-finals regime of B4 and B5 ---------------------------------
# Bars: B4's block against the plain block row by row on every slot the plain
# block writes (in-frame pixels of non-empty tiles), each row normalised by
# its largest magnitude within 1e-4 (2e-3 pinhole), bacc and the logvis rows
# through exp, the visibilities 99.9% within 1e-4 and all within 5e-3 (a
# shadow ray starts at the hit point, which each side gives to its last
# bits, and a grazing occluder's sigmoids magnify that: chip_smoke.py phase
# 18), on the pixels both sides cover; NaN exactly where the plain block is, but in
# the logvis rows, which both write for covered pixels only (1 - exp(bacc) !=
# 0: torch's exp and the card's expf may decide a pixel at that float32 edge
# differently, at most 1e-3 of the written pixels); B5 reading the block
# within 1e-5 of B5 recomputing (JAX's bar between its two regimes) and
# within phase 7's 1e-3 (2e-3 pinhole) of the plain backward; the gradients
# of a NaN-prefilled block finite and within 1e-6 of an unfilled one's (the
# atomics' order); exact zeros for an all-zero cotangent.

FINALS_CASES = [("test", "ortho", "phong", True), ("test", "ortho", "lambert", False),
                ("test", "ortho", "legacy", False), ("test", "pinhole", "phong", True),
                ("three_lights", "ortho", "lambert", True), ("scene3", "ortho", "phong", True)]


def _finals_operands(device, scene_name, cam_kind, shading, shadows):
    S, scene, cam, cfg = _soft_case(device, scene_name, cam_kind, shading, shadows)
    cfg = cfg.replace(width=250, height=123)
    with torch.no_grad():
        params, taus, tables, counts, kc = S.soft_kernel_inputs(scene.pack(), cam, cfg)
    return S, (params, taus, tables, counts), dict(kc, stored_finals=True)


def _norm_err(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("scene_name,cam_kind,shading,shadows", FINALS_CASES)
def test_soft_tiled_fwd_finals_block(cuda_device, scene_name, cam_kind, shading,
                                     shadows):
    S, ops, kc = _finals_operands(cuda_device, scene_name, cam_kind, shading, shadows)
    block = S.finals_block(kc, cuda_device).fill_(float("nan"))
    before = (tracing.counter("launch.B4"), tracing.counter("launch.B4_finals"))
    with torch.no_grad():
        img = S.soft_tiled_fwd(*ops, cfg=kc, finals=block)
        lean = S.soft_tiled_fwd(*ops, cfg=kc)
        want_img, want = S._soft_tiled_plain(*ops, cfg=kc, want_finals=True)
    torch.cuda.synchronize()
    assert (tracing.counter("launch.B4"), tracing.counter("launch.B4_finals")) == (before[0] + 2, before[1] + 1)
    assert torch.equal(img, lean)
    assert (img - want_img).abs().max().item() < 0.05
    names = [n for n, _ in S.finals_layout(kc)]
    n_base = min(len(names), 13)
    written = ~want.isnan()
    assert torch.equal(block[:, :, :n_base].isnan(), want[:, :, :n_base].isnan())
    lv_differ = int((block[:, :, n_base:].isnan() != want[:, :, n_base:].isnan()).sum())
    assert lv_differ <= 1e-3 * int(written[:, :, 0].sum()), lv_differ
    assert not bool((~block[:, :, n_base:].isnan() & ~written[:, :, :1]).any())
    bar = 2e-3 if cam_kind == "pinhole" else 1e-4
    for i, name in enumerate(names):
        mask = written[:, :, i] & ~block[:, :, i].isnan()
        a, b = block[:, :, i][mask], want[:, :, i][mask]
        if name == "bacc" or name.startswith("logvis"):
            a, b = a.exp(), b.exp()
        assert torch.isfinite(a).all(), name
        if name.startswith("logvis"):
            assert _norm_err(a, b) <= 5e-3, (name, _norm_err(a, b))
            assert ((a - b).abs() <= 1e-4).float().mean().item() >= 0.999, name
        else:
            assert _norm_err(a, b) <= bar, (name, _norm_err(a, b))


@pytest.mark.parametrize("scene_name,cam_kind,shading,shadows", FINALS_CASES)
def test_soft_tiled_bwd_reads_the_block(cuda_device, scene_name, cam_kind, shading,
                                        shadows):
    S, ops, kc = _finals_operands(cuda_device, scene_name, cam_kind, shading, shadows)
    h, w = kc["height"], kc["width"]
    gen = torch.Generator(device="cpu").manual_seed(5)
    g = torch.randn((h, w, 4), generator=gen).to(cuda_device)
    g[::5, ::3, :3] = 0.0
    nan_block = S.finals_block(kc, cuda_device).fill_(float("nan"))
    block = S.finals_block(kc, cuda_device)
    with torch.no_grad():
        S.soft_tiled_fwd(*ops, cfg=kc, finals=nan_block)
        S.soft_tiled_fwd(*ops, cfg=kc, finals=block)
    before = (tracing.counter("launch.B5"), tracing.counter("launch.B5_finals"))
    stored = S.soft_tiled_bwd(*ops, g, cfg=kc, finals=block)
    from_nan = S.soft_tiled_bwd(*ops, g, cfg=kc, finals=nan_block)
    zeros = S.soft_tiled_bwd(*ops, torch.zeros_like(g), cfg=kc, finals=nan_block)
    recompute = S.soft_tiled_bwd(*ops, g, cfg=kc)
    torch.cuda.synchronize()
    assert (tracing.counter("launch.B5"), tracing.counter("launch.B5_finals")) == (before[0] + 4, before[1] + 3)
    assert all(bool((z == 0).all()) for z in zeros)
    params, taus, tables, counts = ops
    leaves = [t.detach().requires_grad_(True) for t in (params, taus) + tuple(tables)]
    out = S._soft_tiled_plain(leaves[0], leaves[1], leaves[2:], counts, cfg=kc)
    plain = torch.autograd.grad(out, leaves, g, allow_unused=True)
    bar = 2e-3 if cam_kind == "pinhole" else 1e-3
    for name, a, b, c, d in zip(("params", "taus", "tri_t", "tri_alb", "sph_t",
                                 "sph_alb", "tsh_t", "ssh_t"),
                                stored, from_nan, recompute, plain):
        d = torch.zeros_like(a) if d is None else d
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), name
        if not bool((c != 0).any()):
            assert not bool((a != 0).any()) and not bool((b != 0).any()), name
            continue
        assert _norm_err(b, a) <= 1e-6, (name, _norm_err(b, a))
        assert _norm_err(a, c) <= 1e-5, (name, _norm_err(a, c))
        assert _norm_err(a, d) <= bar, (name, _norm_err(a, d))


@pytest.mark.parametrize("k", [40, 32])
def test_soft_core_stored_finals_branches(cuda_device, monkeypatch, k):
    """`_soft_tiled_core` eagerly on the card (its conds run both branches
    with `run_if`) on the 40-sphere pile, in the stored regime with the block
    prefilled with NaN: at K 40 the tiled branch is taken, at K 32 the brute
    one, where B4 skips and B5 gets a zero cotangent and reads no pixel of
    the unwritten block. Image identical to the recompute regime's, leaf
    gradients finite and within phase 7's 1e-3 normalised of its (two runs
    of B5 or B7 through the gather's autograd: the atomics' order shows in
    a leaf summed near zero)."""
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
    from opencl_ray_tracer_tpu_torch.parallel.train import (
        scene_leaves,
        trainable_scene,
    )

    real = S.finals_block
    monkeypatch.setattr(S, "finals_block",
                        lambda cfg, dev: real(cfg, dev).fill_(float("nan")))
    cam = T.legacy_ortho_camera(device=cuda_device)

    def run(slots):
        monkeypatch.setattr(S, "_FINALS_MIN_SLOTS", slots)
        s = trainable_scene(T.random_scene(40, 0, seed=9, bounds=(60.0, 40.0),
                                           device=cuda_device))
        leaves = scene_leaves(s)
        img = S._soft_tiled_core(s.pack(), cam, 1.0, 0.5, SOFT_H, SOFT_W,
                                 "phong", True, k, 64)
        grads = torch.autograd.grad((img[..., :3] ** 2).mean(),
                                    list(leaves.values()), allow_unused=True)
        return img.detach(), [torch.zeros_like(v) if g is None else g
                              for v, g in zip(leaves.values(), grads)]

    img_r, g_r = run(1 << 30)
    before = (tracing.counter("launch.B4_finals"), tracing.counter("launch.B5_finals"))
    img_s, g_s = run(0)
    torch.cuda.synchronize()
    assert (tracing.counter("launch.B4_finals") - before[0], tracing.counter("launch.B5_finals") - before[1]) == (1, 1)
    assert torch.equal(img_s, img_r)
    for a, b in zip(g_s, g_r):
        assert torch.isfinite(a).all()
        if b.numel():
            assert _norm_err(a, b) <= 1e-3


def test_jit_train_step_stored_finals_matches_eager(cuda_device, monkeypatch):
    """The compiled step in the stored-finals regime (forced through the
    threshold): two make_train_step(jit=True) steps at 256x128 against the
    eager step from the same state, loss and every leaf within 1e-6, with B4
    writing and B5 reading a finals block on both paths."""
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
    from opencl_ray_tracer_tpu_torch.parallel import (
        adam,
        init_train_state,
        make_train_step,
    )
    from opencl_ray_tracer_tpu_torch.parallel.train import scene_leaves

    monkeypatch.setattr(S, "_FINALS_MIN_SLOTS", 0)
    cfg = T.RenderConfig(width=SOFT_W, height=SOFT_H, shading="phong",
                         shadows=True, soft=True, framebuffer_dtype="float",
                         tau_depth=1.0, tau_edge=0.5)
    cam = T.legacy_ortho_camera(device=cuda_device)
    scene = T.random_scene(5, 3, seed=4, bounds=(250.0, 120.0), device=cuda_device)
    target = torch.zeros((SOFT_H, SOFT_W, 4), device=cuda_device)
    opt_e, opt_j = adam(1e-2), adam(1e-2)
    step_e = make_train_step(cam, cfg, opt_e)
    step_j = make_train_step(cam, cfg, opt_j, jit=True)
    se, sj = init_train_state(scene, opt_e), init_train_state(scene, opt_j)
    for i in range(2):
        if i:
            with torch.no_grad():
                for a, b in zip(scene_leaves(se.scene).values(),
                                scene_leaves(sj.scene).values()):
                    b.copy_(a)
                    for k, v in sj.opt_state.state[b].items():
                        v.copy_(se.opt_state.state[a][k])
        before = (tracing.counter("launch.B4_finals"), tracing.counter("launch.B5_finals"))
        se, le = step_e(se, target)
        torch.cuda.synchronize()
        assert (tracing.counter("launch.B4_finals") - before[0],
                tracing.counter("launch.B5_finals") - before[1]) == (1, 1)
        before = (tracing.counter("launch.B4_finals"), tracing.counter("launch.B5_finals"))
        sj, lj = step_j(sj, target)
        torch.cuda.synchronize()
        if i == 0:  # the warm-up and the capture (a replay calls no wrapper)
            assert tracing.counter("launch.B4_finals") - before[0] >= 1
            assert tracing.counter("launch.B5_finals") - before[1] >= 1
        assert abs(lj.item() - le.item()) <= 1e-6 * abs(le.item())
        for k, v in scene_leaves(se.scene).items():
            rel = ((scene_leaves(sj.scene)[k] - v).abs()
                   / v.abs().clamp_min(1e-30)).max().item()
            assert rel <= 1e-6, (i, k, rel)


# ---- the brute kernels B3 (hard), B6 and B7 (soft) -------------------------
# Bars (chip_smoke.py phases 10, 11): B3 float frames within 0.5/255 of the
# twin on every pixel, truncated int frames within 1 and identical on
# >= 99.5%; B6 images within 0.05/255 on every pixel; B7: every operand's
# gradient (params, taus, the four scene arrays) within 1e-3 of the twin's
# autograd, normalised by its largest (2e-3 pinhole).

@pytest.mark.parametrize(
    "scene_num,cam_kind,shading,shadows",
    [
        (1, "ortho", "legacy", False),
        (1, "pinhole", "phong", True),
        (2, "ortho", "lambert", True),
        (3, "ortho", "phong", True),
        (3, "pinhole", "legacy", False),
    ],
)
def test_brute_kernel_matches_twin(cuda_device, scene_num, cam_kind, shading,
                                   shadows):
    from opencl_ray_tracer_tpu_torch.kernels import fwd

    scene = T.create_scene(scene_num, seed=0, device=cuda_device)
    cam = (T.legacy_ortho_camera(device=cuda_device) if cam_kind == "ortho" else
           T.pinhole_camera((320.0, 240.0, 60.0), (320.0, 240.0, -85.0),
                            fov_degrees=80.0, width=W, height=H,
                            device=cuda_device))
    cfg = T.RenderConfig(width=W, height=H, shading=shading, shadows=shadows,
                         framebuffer_dtype="float")
    args, kw = fwd.brute_kernel_inputs(scene.pack(), cam, cfg)
    before = tracing.counter("launch.B3")
    got = fwd.brute_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert tracing.counter("launch.B3") == before + 1
    want = fwd._brute_kernel_plain(*args, **kw)
    assert got.shape == want.shape == (H, W, 4)
    assert (got - want).abs().max().item() < 0.5
    ierr = (torch.trunc(got) - torch.trunc(want)).abs().amax(-1)
    assert ierr.max().item() <= 1
    assert (ierr == 0).float().mean().item() >= 0.995
    with pytest.raises(ValueError):
        fwd.brute_kernel(*args, **{**kw, "n_tris": args[1].shape[1] + 1})
    with pytest.raises(TypeError):
        fwd.brute_kernel(args[0].double(), *args[1:], **kw)


# A 1080p frame runs B3 with four pixels a thread (the 640x480 frames above
# run one a thread); 1918 is no multiple of the 128 pixels a warp then covers.
@pytest.mark.parametrize("cam_kind,shading,shadows,width",
                         [("ortho", "legacy", False, 1920),
                          ("ortho", "phong", True, 1918),
                          ("pinhole", "phong", True, 1920)])
def test_brute_kernel_full_frame_identical_to_twin(cuda_device, cam_kind,
                                                   shading, shadows, width):
    from opencl_ray_tracer_tpu_torch.kernels import fwd

    height = 1080
    scene = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0),
                           device=cuda_device)
    cam = (T.legacy_ortho_camera(device=cuda_device) if cam_kind == "ortho" else
           T.pinhole_camera((960.0, 540.0, 1100.0), (960.0, 540.0, -60.0),
                            fov_degrees=50.0, width=width, height=height,
                            device=cuda_device))
    cfg = T.RenderConfig(width=width, height=height, shading=shading,
                         shadows=shadows, framebuffer_dtype="float")
    args, kw = fwd.brute_kernel_inputs(scene.pack(), cam, cfg)
    got = fwd.brute_kernel(*args, **kw)
    want = fwd._brute_kernel_plain(*args, **kw)
    assert (got[..., :3] != 0).any(), "the camera sees nothing"
    assert (got - want).abs().max().item() < 0.5
    assert (got == want).all(-1).float().mean().item() >= 0.9999


@pytest.mark.parametrize("cam_kind", ["ortho", "pinhole"])
def test_brute_kernel_staged_shadow_walk(cuda_device, cam_kind):
    """4,800 triangles: more geometry than a block's shared memory holds,
    so B3's shadow walk stages it 128 primitives at a time."""
    from opencl_ray_tracer_tpu_torch.kernels import fwd

    w, h = 160, 120
    scene = T.random_scene(20, 400, seed=2, bounds=(150.0, 110.0),
                           device=cuda_device)
    cam = (T.legacy_ortho_camera(device=cuda_device) if cam_kind == "ortho" else
           T.pinhole_camera((w / 2.0, h / 2.0, 60.0), (w / 2.0, h / 2.0, -85.0),
                            fov_degrees=80.0, width=w, height=h,
                            device=cuda_device))
    cfg = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                         framebuffer_dtype="float")
    args, kw = fwd.brute_kernel_inputs(scene.pack(), cam, cfg)
    assert kw["n_tris"] * 48 + kw["n_spheres"] * 16 > 200 * 1024
    got = fwd.brute_kernel(*args, **kw)
    assert (got != fwd.brute_kernel(*args, **{**kw, "shadows": False})).any()
    want = fwd._brute_kernel_plain(*args, **kw)
    assert (got - want).abs().max().item() < 0.5
    assert (got == want).all(-1).float().mean().item() >= 0.995


def _cotangent(kind, want):
    """Pixel cotangents for B7: that of mean(img^2), zeros, a few scattered
    pixels, one whole 8x4 patch of the kernel, or every pixel."""
    g = torch.zeros_like(want)
    if kind == "loss":
        g[..., :3] = 2.0 * want[..., :3] / (SOFT_H * SOFT_W * 3)
    elif kind == "scattered":
        g[3, 5, 1], g[77, 200, 0], g[SOFT_H - 1, SOFT_W - 1, 2] = 1.0, -2.0, 0.5
    elif kind == "patch":
        g[40:44, 96:104, :3] = 0.5
    elif kind == "dense":
        g[..., :3] = 1e-3
    return g


# scene3: 1,300 primitives; big: 2,600, more than B7's accumulators once held;
# two_lights / three_lights: the kernels built for a light count read at run
# time (one light has a build of its own)
@pytest.mark.parametrize(
    "scene_name,cam_kind,shading,shadows,cotangent",
    [("test", cam_kind, shading, shadows, "loss")
     for shading, shadows in (("legacy", False), ("lambert", False),
                              ("lambert", True), ("phong", True))
     for cam_kind in ("ortho", "pinhole")]
    + [("scene3", "ortho", "phong", True, "loss"),
       ("big", "ortho", "phong", True, "loss"),
       ("two_lights", "ortho", "phong", True, "loss"),
       ("two_lights", "pinhole", "lambert", True, "loss"),
       ("three_lights", "ortho", "lambert", False, "dense")]
    + [("test", "ortho", "phong", True, kind)
       for kind in ("zero", "scattered", "patch", "dense")])
def test_soft_brute_kernels_match_twin(cuda_device, scene_name, cam_kind,
                                       shading, shadows, cotangent):
    from opencl_ray_tracer_tpu_torch.kernels import soft

    _, scene, cam, _ = _soft_case(cuda_device, scene_name, cam_kind, shading,
                                  shadows)
    packed = scene.pack()
    inputs = [soft._camera_params(cam, packed.lights).contiguous(),
              torch.tensor([1.0, 0.5], device=cuda_device)]
    inputs += [a.contiguous() for a in soft._prep_soft_arrays(packed)]
    kw = dict(height=SOFT_H, width=SOFT_W,
              cfg=soft._static_cfg(packed, shading, shadows, cam.normalize))
    before = (tracing.counter("launch.B6"), tracing.counter("launch.B7"))
    got = soft.soft_brute_fwd(*inputs, **kw)
    with torch.no_grad():
        want = soft._soft_brute_plain(*inputs, **kw)
    assert (got - want).abs().max().item() < 0.05
    g = _cotangent(cotangent, want)
    gk, live = soft._soft_brute_bwd_cuda(inputs, g, SOFT_H, SOFT_W, kw["cfg"])
    torch.cuda.synchronize()
    assert (tracing.counter("launch.B6"), tracing.counter("launch.B7")) == (
        before[0] + 1, before[1] + 1)
    # the list of live patches that the card built, against its plain version
    want_live = soft._live_patches(g)
    assert live[0].item() == want_live.numel()
    assert torch.equal(live[2:2 + want_live.numel()].sort().values.long(), want_live)
    if cotangent == "zero":
        assert all(bool((a == 0).all()) for a in gk)
        return
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    gt = torch.autograd.grad(soft._soft_brute_plain(*leaves, **kw), leaves, g,
                             allow_unused=True)
    atol = 1e-3 if cam_kind == "ortho" else 2e-3
    for name, a, b in zip(("params", "taus", "tri_geo", "tri_alb", "sph_geo",
                           "sph_alb"), gk, gt):
        assert torch.isfinite(a).all(), name
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= atol * scale + 1e-12, name


@pytest.mark.parametrize("fmt", ["int", "float"])
def test_reference_backend_runs_on_the_host_cpu(cuda_device, fmt):
    """render(backend="reference") on a card scene computes on the host CPU
    and returns a CPU tensor, equal to _render_oracle on the same scene
    moved to the CPU; _render_oracle follows the scene onto the card."""
    from opencl_ray_tracer_tpu_torch.ref.tracer import _render_oracle
    from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays, scene_to_arrays

    scene = T.create_scene(1, seed=0, device=cuda_device)
    cam = T.legacy_ortho_camera(device=cuda_device)
    cfg = T.RenderConfig(width=W, height=H, shading="phong", shadows=True,
                         framebuffer_dtype=fmt)
    got = T.render(scene, cam, cfg, backend="reference")
    assert got.device.type == "cpu"
    cpu = torch.device("cpu")
    want = _render_oracle(scene_from_arrays(scene_to_arrays(scene), cpu),
                          cam.to(cpu), cfg)
    assert torch.equal(got, want)
    on_card = _render_oracle(scene, cam, cfg)
    assert on_card.device.type == "cuda"
    assert T.Renderer(cfg, cam).render_cpu(scene).device.type == "cpu"


# ---- the compiled path: the kernels' device-side branch and CUDA graphs ----


def test_graph_host_read_inside_capture_raises(cuda_device):
    """A host read inside a captured function fails the capture, which
    raises with CUDA's message: it does not run the function eagerly."""
    from opencl_ray_tracer_tpu_torch.runtime.graph import jit

    calls = []

    def fn(x):
        calls.append(1)
        return x * float(x.sum().item())

    with pytest.raises(RuntimeError, match="CUDA graph"):
        jit(fn)(torch.ones(4, device=cuda_device))
    assert len(calls) == 3  # two warm-up runs on a side stream, one capture
    # the card is still usable, and a capturable function captures
    f = jit(lambda x: x * 2.0)
    out = f(torch.ones(4, device=cuda_device))
    assert torch.equal(out, torch.full((4,), 2.0, device=cuda_device))
    out = f(torch.full((4,), 3.0, device=cuda_device))
    assert torch.equal(out, torch.full((4,), 6.0, device=cuda_device))


@pytest.mark.parametrize("kernel", ["B1", "B3", "B4", "B6"])
def test_run_if_runs_or_skips_the_kernel(cuda_device, kernel):
    """Each forward with run_if: the kernel's frame where *run_if == want,
    all zeros where not, and a skipped launch is still a launch."""
    from opencl_ray_tracer_tpu_torch.kernels import fwd, soft
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S

    scene = T.create_scene(1, seed=0, device=cuda_device)
    cam = T.legacy_ortho_camera(device=cuda_device)
    packed = scene.pack()
    if kernel in ("B1", "B3"):
        cfg = T.RenderConfig(width=W, height=H, shading="phong", shadows=True,
                             framebuffer_dtype="packed" if kernel == "B1" else "float")
        if kernel == "B1":
            args, kw = _inputs(cuda_device, 1, "ortho", "phong", True, "packed")
            call = lambda **b: fwd_tiled.tiled_kernel(*args, **kw, **b)  # noqa: E731
            launches = "launch.B1"
        else:
            args, kw = fwd.brute_kernel_inputs(packed, cam, cfg)
            call = lambda **b: fwd.brute_kernel(*args, **kw, **b)  # noqa: E731
            launches = "launch.B3"
    else:
        cfg = T.RenderConfig(width=SOFT_W, height=SOFT_H, shading="phong",
                             shadows=True, soft=True, framebuffer_dtype="float",
                             tau_depth=1.0, tau_edge=0.5)
        if kernel == "B4":
            params, taus, tables, counts, kc = S.soft_kernel_inputs(packed, cam, cfg)
            call = lambda **b: S.soft_tiled_fwd(  # noqa: E731
                params, taus, tables, counts, cfg=kc, **b)
            launches = "launch.B4"
        else:
            inputs = [soft._camera_params(cam, packed.lights).contiguous(),
                      torch.tensor([1.0, 0.5], device=cuda_device)]
            inputs += [a.contiguous() for a in soft._prep_soft_arrays(packed)]
            kw = dict(height=SOFT_H, width=SOFT_W,
                      cfg=soft._static_cfg(packed, "phong", True, False))
            call = lambda **b: soft.soft_brute_fwd(*inputs, **kw, **b)  # noqa: E731
            launches = "launch.B6"
    with torch.no_grad():
        want = call()
        for flag, wanted in ((0, 0), (1, 1), (1, 0), (0, 1)):
            before = tracing.counter(launches)
            got = call(run_if=torch.tensor(flag, dtype=torch.int32,
                                           device=cuda_device), want=wanted)
            torch.cuda.synchronize()
            assert tracing.counter(launches) == before + 1
            if flag == wanted:
                assert torch.equal(got, want), (flag, wanted)
            else:
                assert not got.any(), (flag, wanted)


@pytest.mark.parametrize("cull_k", [32, 8])
def test_entry_replay_matches_eager(cuda_device, cull_k):
    """entry()'s captured frame, replayed with the camera moved: the eager
    render_tiled_packed frame word for word where the lists fit (K 32), and
    the brute kernel's frame, packed on the card, where they overflow (K 8;
    render_jit at that K)."""
    import dataclasses

    from opencl_ray_tracer_tpu_torch.entry import entry
    from opencl_ray_tracer_tpu_torch.kernels import fwd
    from opencl_ray_tracer_tpu_torch.models.renderer import render_jit
    from opencl_ray_tracer_tpu_torch.ops.shading import pack_framebuffer_words

    forward, (scene, cam) = entry()
    cfg = T.RenderConfig(width=640, height=480, shading="phong", shadows=True,
                         framebuffer_dtype="packed", cull_k=cull_k,
                         shadow_cull_k=64 if cull_k == 32 else 8)
    if cull_k != 32:
        forward = render_jit(cfg)
    packed = scene.pack()
    for d in ([0.0, 0.0, 0.0], [2.5, -1.25, 0.0]):
        c = dataclasses.replace(cam, o0=cam.o0 + torch.tensor(d, device=cuda_device))
        got = forward(scene, c).clone()
        overflow = bool(fwd_tiled.bin_fixed(packed, c, cfg).overflow)
        assert overflow == (cull_k == 8)
        if overflow:
            want = pack_framebuffer_words(fwd.render_pallas_packed(
                packed, c, cfg.replace(framebuffer_dtype="float")))
        else:
            want = fwd_tiled.render_tiled_packed(packed, c, cfg)
        assert torch.equal(got, want), d


def _branch_case(case):
    """One compiled case of `test_replay_runs_only_the_branch_taken`, in
    this process: (kernels its replay ran, kernels of the branch taken,
    kernels of the other branch) from a profiler trace of one replay, after
    checking the replay's result against the eager call's, and the card's
    counter of the soft forward's cond (`cond.soft_tiled.fwd.brute`, the
    one cond that names a site) against the replays that took the brute
    branch."""
    from opencl_ray_tracer_tpu_torch.kernels import fwd
    from opencl_ray_tracer_tpu_torch.models.renderer import render_jit
    from opencl_ray_tracer_tpu_torch.ops.shading import pack_framebuffer_words
    from opencl_ray_tracer_tpu_torch.parallel import (
        adam,
        init_train_state,
        make_train_step,
    )
    from opencl_ray_tracer_tpu_torch.utils.profiling import kernels_in, trace_ops

    dev = torch.device("cuda")
    cam = T.legacy_ortho_camera(device=dev)
    brute = case.endswith("brute")
    if case.startswith("frame"):
        scene = T.create_scene(1, seed=0, device=dev)
        cfg = T.RenderConfig(width=160, height=120, shading="phong", shadows=True,
                             framebuffer_dtype="packed")
        if brute:
            cfg = cfg.replace(cull_k=8, shadow_cull_k=8)
        packed = scene.pack()
        assert bool(fwd_tiled.bin_fixed(packed, cam, cfg).overflow) == brute
        fn = render_jit(cfg)
        got = fn(scene, cam).clone()
        if brute:
            want = pack_framebuffer_words(fwd.render_pallas_packed(
                packed, cam, cfg.replace(framebuffer_dtype="float")))
        else:
            want = fwd_tiled.render_tiled_packed(packed, cam, cfg)
        assert torch.equal(got, want)
        seen = kernels_in(trace_ops(lambda: fn(scene, cam)))
        taken, other = ({"B3"}, {"B1/B2"}) if brute else ({"B1/B2"}, {"B3"})
        sites, name = (), "render_tiled_fixed"
    else:
        w, h = 128, 64
        if brute:
            scene = T.random_scene(40, 0, seed=9, bounds=(60.0, 40.0), device=dev)
            shading, shadows = "lambert", False
        else:
            scene = T.random_scene(5, 2, seed=4, bounds=(120.0, 60.0), device=dev)
            shading, shadows = "phong", True
        cfg = T.RenderConfig(width=w, height=h, shading=shading, shadows=shadows,
                             soft=True, framebuffer_dtype="float", tau_depth=1.0,
                             tau_edge=0.5)
        target = torch.zeros((h, w, 4), device=dev)
        opt_e, opt_j = adam(1e-2), adam(1e-2)
        step_e = make_train_step(cam, cfg, opt_e)
        step_j = make_train_step(cam, cfg, opt_j, jit=True)
        se, sj = init_train_state(scene, opt_e), init_train_state(scene, opt_j)
        se, le = step_e(se, target)
        sj, lj = step_j(sj, target)
        assert abs(lj.item() - le.item()) <= 1e-6 * abs(le.item())
        seen = kernels_in(trace_ops(lambda: step_j(sj, target)))
        taken, other = ({"B6", "B7"}, {"B4", "B5"}) if brute \
            else ({"B4", "B5"}, {"B6", "B7"})
        sites, name = ("soft_tiled.fwd",), "train step"
    replays = 3  # the first call's, then trace_ops's two
    assert tracing.counter(f"graph.replays.{name}") == replays
    counts = {site: tracing.counter(f"cond.{site}.brute") for site in sites}
    assert counts == dict.fromkeys(sites, replays if brute else 0), counts
    return sorted(seen), sorted(taken), sorted(other)


@pytest.mark.parametrize("case", ["frame-tiled", "frame-brute", "step-tiled",
                                  "step-brute"])
def test_replay_runs_only_the_branch_taken(cuda_device, case):
    """A profiler trace of one replay holds the kernels of the branch of
    `runtime.graph.cond` taken and none of the other branch's: the 160x120
    frame through render_jit (scene 1 at the default caps: B1 and no B3; at
    cull_k 8, where its lists overflow: B3 and no B1) and the 128x64 soft
    train step through make_train_step(jit=True) (a scene that fits its
    lists: B4 and B5, no B6 or B7; the 40-sphere pile, which overflows K
    32: B6 and B7, no B4 or B5). The replay's result is the eager call's.
    Each case runs in a process of its own: a trace names kernels inside
    conditional nodes wrongly once a process holds graphs of several
    shapes (chip_smoke.py, `BRANCH_CASES`)."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), case],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    seen, taken, other = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(taken) <= set(seen) and not set(seen) & set(other), (case, seen)


def test_jit_train_step_matches_eager_step(cuda_device):
    """Two make_train_step(jit=True) steps at 256x128 against the eager step
    from the same state: loss and every leaf within 1e-6 (relative)."""
    from opencl_ray_tracer_tpu_torch.parallel import (
        adam,
        init_train_state,
        make_train_step,
    )
    from opencl_ray_tracer_tpu_torch.parallel.train import scene_leaves

    cfg = T.RenderConfig(width=SOFT_W, height=SOFT_H, shading="phong",
                         shadows=True, soft=True, framebuffer_dtype="float",
                         tau_depth=1.0, tau_edge=0.5)
    cam = T.legacy_ortho_camera(device=cuda_device)
    scene = T.random_scene(5, 3, seed=4, bounds=(250.0, 120.0), device=cuda_device)
    target = torch.zeros((SOFT_H, SOFT_W, 4), device=cuda_device)
    opt_e, opt_j = adam(1e-2), adam(1e-2)
    assert opt_e([torch.zeros(1, device=cuda_device)]).defaults["capturable"]
    step_e = make_train_step(cam, cfg, opt_e)
    step_j = make_train_step(cam, cfg, opt_j, jit=True)
    se, sj = init_train_state(scene, opt_e), init_train_state(scene, opt_j)
    for i in range(2):
        if i:
            with torch.no_grad():
                for a, b in zip(scene_leaves(se.scene).values(),
                                scene_leaves(sj.scene).values()):
                    b.copy_(a)
                    for k, v in sj.opt_state.state[b].items():
                        v.copy_(se.opt_state.state[a][k])
        se, le = step_e(se, target)
        sj, lj = step_j(sj, target)
        assert abs(lj.item() - le.item()) <= 1e-6 * abs(le.item())
        for k, v in scene_leaves(se.scene).items():
            rel = ((scene_leaves(sj.scene)[k] - v).abs()
                   / v.abs().clamp_min(1e-30)).max().item()
            assert rel <= 1e-6, (i, k, rel)


@pytest.mark.parametrize("shape", [(1,), (1, 1)])
def test_jit_mesh_step_on_nccl_matches_eager_step(cuda_device, shape):
    """make_train_step(jit=True) over a one-rank NCCL group (make_mesh(1),
    and make_mesh_2d(1, 1): two one-rank communicators in one graph), the
    all-reduce captured in the CUDA graph: two steps against the eager mesh
    step from the same state, loss and every leaf within 1e-6 (relative)."""
    import torch.distributed as dist

    from opencl_ray_tracer_tpu_torch.parallel import (
        adam,
        distributed,
        init_train_state,
        make_mesh,
        make_mesh_2d,
        make_train_step,
        replicate,
        shard_rows,
    )
    from opencl_ray_tracer_tpu_torch.parallel.train import scene_leaves

    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0)
    try:
        mesh = make_mesh(1) if len(shape) == 1 else make_mesh_2d(1, 1)
        assert all(dist.get_backend(g) == "nccl" for g in mesh.reduce_groups)
        cfg = T.RenderConfig(width=SOFT_W, height=SOFT_H, shading="phong",
                             shadows=True, soft=True, framebuffer_dtype="float",
                             tau_depth=1.0, tau_edge=0.5)
        cam = T.legacy_ortho_camera(device=cuda_device)
        scene = T.random_scene(5, 3, seed=4, bounds=(250.0, 120.0),
                               device=cuda_device)
        target = shard_rows(torch.zeros((SOFT_H, SOFT_W, 4), device=cuda_device),
                            mesh)
        opt_e, opt_j = adam(1e-2), adam(1e-2)
        step_e = make_train_step(cam, cfg, opt_e, mesh=mesh)
        step_j = make_train_step(cam, cfg, opt_j, mesh=mesh, jit=True)
        se = init_train_state(replicate(scene, mesh), opt_e)
        sj = init_train_state(replicate(scene, mesh), opt_j)
        for i in range(2):
            if i:
                with torch.no_grad():
                    for a, b in zip(scene_leaves(se.scene).values(),
                                    scene_leaves(sj.scene).values()):
                        b.copy_(a)
                        for k, v in sj.opt_state.state[b].items():
                            v.copy_(se.opt_state.state[a][k])
            se, le = step_e(se, target)
            sj, lj = step_j(sj, target)
            assert abs(lj.item() - le.item()) <= 1e-6 * abs(le.item())
            for k, v in scene_leaves(se.scene).items():
                rel = ((scene_leaves(sj.scene)[k] - v).abs()
                       / v.abs().clamp_min(1e-30)).max().item()
                assert rel <= 1e-6, (i, k, rel)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":  # one case of test_replay_runs_only_the_branch_taken
    import json
    import sys

    print(json.dumps(_branch_case(sys.argv[1])))
