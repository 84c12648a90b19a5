"""The binning and gather kernels (kernels/csrc/bin_tiled.cu) against their
plain twins, on the card.

These need an NVIDIA card and nvcc (the kernels have no CPU mode), so they
skip where torch.cuda.is_available() is false. Run them on the card with:

    python -m pytest tests/test_torch_bin_kernel_gpu.py -q

`bin_scene` and `kernel_inputs` on CUDA tensors launch the kernels; on CPU
copies of the same scene and camera they run the twins (`_bin_scene_plain`,
`_gather_plain`). The bars are tests/test_torch_binning.py's: the lists,
counts and overflow flag equal (they come from comparisons); the computed
float rows (shadow planes, coefficients, the triangles' unit normals) agree
to rtol 1e-5 / atol 1e-4 (the kernels fuse and order each sum of products
as PyTorch's CPU build does; the bar leaves room for another build's
rounding); rows copied from the scene (colours, centres, 1 / r, the sphere
occluder rows, params) and null rows are equal.
"""

import os

import pytest
import torch

import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
from opencl_ray_tracer_tpu_torch.runtime import graph
from opencl_ray_tracer_tpu_torch.scene.scene import Lights
from opencl_ray_tracer_tpu_torch.utils import pack_rgba, read_png, tracing

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

pytestmark = pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs an NVIDIA card: the CUDA kernels have no CPU mode")

W, H = 640, 360
EXACT = ("t_idx", "t_valid", "s_idx", "s_valid", "counts", "overflow")
STATIC = ("k_tri", "k_sph", "k_sh_tri", "k_sh_sph", "nty", "ntx", "projective")
NORMALS = slice(3, 6)  # tri_attr_t's computed columns


def lights(n, dev):
    """n point lights about the frame (n = 1: the port's default light)."""
    if n == 1:
        return Lights.default(dev)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    pos = [[200.0, 100.0, 200.0], [600.0, 300.0, 150.0], [-100.0, 500.0, 80.0]]
    return Lights(position=f(pos[:n]), colour=f([[1.0, 0.9, 0.8]] * n),
                  intensity=f([0.6] * n), ambient=f(0.1),
                  spec_strength=f(0.5), shininess=f(32.0))


def scene(kind, n_lights, dev):
    """rt10: 10 spheres and a cube; spheres / triangles: one kind only;
    pile: 40 spheres on one spot, whose tiles overflow K 32."""
    lt = lights(n_lights, dev)
    if kind == "rt10":
        return T.random_scene(10, 1, seed=11, bounds=(W, H), lights=lt, device=dev)
    if kind == "spheres":
        return T.random_scene(12, 0, seed=5, bounds=(W, H), lights=lt, device=dev)
    if kind == "triangles":
        return T.random_scene(0, 3, seed=7, bounds=(W, H), lights=lt, device=dev)
    g = torch.Generator().manual_seed(9)
    n = 40
    origin = torch.cat([torch.rand(n, 2, generator=g) * 60.0 + 40.0,
                        -20.0 - 80.0 * torch.rand(n, 1, generator=g)], dim=1)
    return T.Scene.build(device=dev, sphere_origin=origin,
                         sphere_radius=5.0 + 25.0 * torch.rand(n, generator=g),
                         sphere_colour=torch.rand(n, 4, generator=g), lights=lt)


def camera(kind, dev):
    """ortho (the reference's), shifted (its origin offset by sub-pixels),
    pinhole, inside (a pinhole among the primitives: some reach behind its
    near plane and bin to the whole screen), or None (bins without one)."""
    if kind == "none":
        return None
    if kind == "ortho":
        return T.legacy_ortho_camera(device=dev)
    if kind == "shifted":
        return T.legacy_ortho_camera(device=dev).shift_subpixel(3.25, -1.625)
    pos = (W / 2.0, H / 2.0, 600.0) if kind == "pinhole" else (W / 2.0, H / 2.0, -50.0)
    return T.pinhole_camera(pos, (W / 2.0 + 20.0, H / 2.0 - 10.0, -200.0),
                            fov_degrees=60.0, width=W, height=H, device=dev)


# (scene, camera, shadows, lights, K, shadow K)
CASES = [
    ("rt10", "ortho", True, 1, 32, 64),
    ("rt10", "pinhole", True, 1, 32, 64),
    ("rt10", "ortho", False, 1, 32, 64),
    ("rt10", "pinhole", False, 1, 32, 64),
    ("rt10", "ortho", True, 3, 32, 64),
    ("rt10", "pinhole", True, 3, 32, 64),
    ("rt10", "shifted", True, 1, 32, 64),
    ("rt10", "inside", True, 1, 32, 64),
    ("rt10", "none", True, 1, 32, 64),
    ("spheres", "ortho", True, 1, 32, 64),
    ("spheres", "pinhole", True, 3, 32, 64),
    ("triangles", "ortho", True, 3, 32, 64),
    ("triangles", "pinhole", True, 1, 32, 64),
    ("pile", "ortho", True, 1, 32, 16),
    ("pile", "pinhole", True, 1, 32, 64),
]


def case_inputs(case, dev):
    """(packed scene, camera, bin_scene's keywords) of a case on `dev`."""
    kind, cam_kind, shadows, n_lights, k, shadow_k = case
    return (scene(kind, n_lights, dev).pack(), camera(cam_kind, dev),
            dict(height=H, width=W, k=k, shadows=shadows, shadow_k=shadow_k))


def compare_bins(got, want):
    """Kernel bins (any device) against the twin's, by the module's bars."""
    for f in STATIC:
        assert getattr(got, f) == getattr(want, f), f
    for f in EXACT:
        g, w = getattr(got, f).cpu(), getattr(want, f)
        assert g.dtype == w.dtype and torch.equal(g, w), f
    ga, wa = got.tri_attr_t.cpu(), want.tri_attr_t
    keep = torch.ones(8, dtype=torch.bool)
    keep[NORMALS] = False
    assert torch.equal(ga[..., keep], wa[..., keep]), "tri_attr_t"
    torch.testing.assert_close(ga[..., NORMALS], wa[..., NORMALS], rtol=1e-5,
                               atol=1e-4)
    assert torch.equal(got.sph_attr_t.cpu(), want.sph_attr_t), "sph_attr_t"
    assert torch.equal(got.sph_sh_t.cpu(), want.sph_sh_t), "sph_sh_t"
    torch.testing.assert_close(got.tri_sh_t.cpu(), want.tri_sh_t, rtol=1e-5,
                               atol=1e-4)


def compare_inputs(got, want):
    """kernel_inputs' args from the kernels against the twin's: params
    equal, coefficient tables within the bars (null rows equal)."""
    (gp, _, gt, _, gs, _, _, _), (wp, _, wt, _, ws, _, _, _) = got, want
    assert torch.equal(gp.cpu(), wp), "params"
    for name, g, w in (("tri_coef_t", gt, wt), ("sph_coef_t", gs, ws)):
        g = g.cpu()
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4, msg=name)


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_kernels_match_the_twins(case):
    tracing.reset()
    packed, cam, kw = case_inputs(case, torch.device("cuda"))
    packed_c, cam_c, _ = case_inputs(case, torch.device("cpu"))
    got = fwd_tiled.bin_scene(packed, camera=cam, **kw)
    want = fwd_tiled.bin_scene(packed_c, camera=cam_c, **kw)
    assert tracing.counter("launch.bin") == 1
    compare_bins(got, want)
    if case[0] == "pile":
        assert bool(got.overflow)
    if cam is None:
        return
    shading = dict(height=H, width=W, shading="phong", shadows=kw["shadows"])
    args, _ = fwd_tiled.kernel_inputs(packed, cam, got, **shading)
    want_args, _ = fwd_tiled.kernel_inputs(packed_c, cam_c, want, **shading)
    assert tracing.counter("launch.gather") == 1
    compare_inputs(args, want_args)


def test_a_capture_counts_no_launch():
    dev = torch.device("cuda")
    packed, cam, kw = case_inputs(CASES[1], dev)
    fwd_tiled.kernel_inputs(packed, cam, fwd_tiled.bin_scene(packed, camera=cam, **kw),
                            height=H, width=W, shading="phong", shadows=True)
    torch.cuda.synchronize()
    tracing.reset()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        bins = fwd_tiled.bin_scene(packed, camera=cam, **kw)
        args, _ = fwd_tiled.kernel_inputs(packed, cam, bins, height=H, width=W,
                                          shading="phong", shadows=True)
    assert tracing.counter("launch.bin") == 0
    assert tracing.counter("launch.gather") == 0
    g.replay()
    torch.cuda.synchronize()
    packed_c, cam_c, _ = case_inputs(CASES[1], torch.device("cpu"))
    compare_bins(bins, fwd_tiled.bin_scene(packed_c, camera=cam_c, **kw))


@pytest.mark.parametrize("cam_kind", ["ortho", "pinhole"])
def test_the_replayed_frame_is_the_eager_frame(monkeypatch, cam_kind):
    monkeypatch.setattr(fwd_tiled, "_FRAME_GRAPHS", graph.GraphCache("render_tiled"))
    tracing.reset()
    dev = torch.device("cuda")
    sc, cam = scene("rt10", 1, dev), camera(cam_kind, dev)
    cfg = T.RenderConfig(width=W, height=H, shading="phong", shadows=True,
                         framebuffer_dtype="packed")
    eager = fwd_tiled.render_tiled(sc, cam, cfg)
    assert tracing.counter("frame.eager") == 1
    assert tracing.counter("launch.bin") == 1  # once an eager frame
    frames = [fwd_tiled.render_tiled(sc, cam, cfg) for _ in range(3)]
    after_capture = tracing.counter("launch.bin")
    frames += [fwd_tiled.render_tiled(sc, cam, cfg) for _ in range(2)]
    assert tracing.counter("frame.replayed") == 5
    assert tracing.counter("launch.bin") == after_capture  # replays launch nothing
    packed = sc.pack()
    want = fwd_tiled.render_tiled_packed(packed, cam, cfg,
                                         bins=fwd_tiled.bin_for_config(packed, cam, cfg))
    for i, frame in enumerate([eager] + frames):
        assert torch.equal(frame, want), f"frame {i} differs from the eager frame"



@pytest.mark.parametrize("name,shading,shadows,cam_kind", [
    ("pallas_scene1_legacy", "legacy", False, "ortho"),
    ("pallas_scene1_phong", "phong", True, "ortho"),
    ("pallas_scene1_pinhole", "legacy", False, "pinhole"),
    ("pallas_scene1_pinhole_phong", "phong", True, "pinhole"),
])
def test_golden_frames_from_the_kernels_tables(name, shading, shadows, cam_kind):
    """The committed tiled goldens (test_torch_fwd_tiled.py's
    test_hard_golden) drawn on the card from the kernels' tables: > 99.9%
    of pixels identical, the twin's bar. On scene 1 the tables are the CPU
    twin's bit for bit: an unfused cross product leaves the triangles'
    coefficient rows an ulp off, which flips edge pixels of these frames."""
    w, h = 160, 120
    cfg = T.RenderConfig(width=w, height=h, shading=shading, shadows=shadows,
                         framebuffer_dtype="int" if shading == "legacy" else "float")
    frame, tables = {}, {}
    for dev in ("cuda", "cpu"):
        sc = T.create_scene1(device=torch.device(dev))
        cam = (T.legacy_ortho_camera(device=torch.device(dev)) if cam_kind == "ortho"
               else T.pinhole_camera((320.0, 240.0, 60.0), (320.0, 240.0, -85.0),
                                     fov_degrees=80.0, width=w, height=h,
                                     device=torch.device(dev)))
        packed = sc.pack()
        args, _ = fwd_tiled.kernel_inputs(
            packed, cam, fwd_tiled.bin_for_config(packed, cam, cfg), height=h,
            width=w, shading=shading, shadows=shadows)
        tables[dev] = [a.cpu() for a in args]
        frame[dev] = fwd_tiled.render_tiled(sc, cam, cfg)
    for i, (got, want) in enumerate(zip(tables["cuda"], tables["cpu"])):
        assert torch.equal(got, want), f"kernel_inputs' table {i} differs from the twin's"
    want = read_png(os.path.join(os.path.dirname(__file__), "golden", f"{name}.png"))
    same = (pack_rgba(frame["cuda"]) == want).all(axis=-1).mean()
    assert same > 0.999, f"{name}: only {same:.4%} identical to golden"
