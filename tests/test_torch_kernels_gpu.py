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
from opencl_ray_tracer_tpu_torch.utils import unpack_words

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
    before = fwd_tiled.KERNEL_LAUNCHES
    got = fwd_tiled.tiled_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert fwd_tiled.KERNEL_LAUNCHES == before + 1
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
    before = (S.FWD_LAUNCHES, S.BWD_LAUNCHES)
    with torch.no_grad():
        got = S.render_soft_tiled(scene, cam, cfg)
        want = _twin(scene, cam, cfg)
    assert (got - want).abs().max().item() < 0.05
    gk = _soft_grads(S.render_soft_tiled, scene, cam, cfg)
    gt = _soft_grads(_twin, scene, cam, cfg)
    assert S.FWD_LAUNCHES > before[0] and S.BWD_LAUNCHES > before[1]
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
        before = S.FWD_LAUNCHES
        got, tiles = S._soft_tiled_fwd_cuda(params, taus, tables, counts, kc)
        torch.cuda.synchronize()
        assert S.FWD_LAUNCHES == before + 1
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
    before = S.BWD_LAUNCHES
    inputs = (params, taus) + tuple(tables)
    got, live = S._soft_tiled_bwd_cuda(params, taus, tables, counts, g, kc)
    torch.cuda.synchronize()
    assert S.BWD_LAUNCHES == before + 1
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
    before = fwd.BRUTE_LAUNCHES
    got = fwd.brute_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert fwd.BRUTE_LAUNCHES == before + 1
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
    before = (soft.SOFT_BRUTE_FWD_LAUNCHES, soft.SOFT_BRUTE_BWD_LAUNCHES)
    got = soft.soft_brute_fwd(*inputs, **kw)
    with torch.no_grad():
        want = soft._soft_brute_plain(*inputs, **kw)
    assert (got - want).abs().max().item() < 0.05
    g = _cotangent(cotangent, want)
    gk, live = soft._soft_brute_bwd_cuda(inputs, g, SOFT_H, SOFT_W, kw["cfg"])
    torch.cuda.synchronize()
    assert (soft.SOFT_BRUTE_FWD_LAUNCHES, soft.SOFT_BRUTE_BWD_LAUNCHES) == (
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
