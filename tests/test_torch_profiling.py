"""utils/profiling.py on the CPU: each H100 bound on a tiny frame, through
the kernels' plain twins, against a count made by hand from the frame's
content (one sphere in one 64x128 tile, one light); the speed-of-light
arithmetic; the profiler wrappers; and that chip_smoke.py keeps no bound
code of its own."""

import json
import os

import pytest
import torch

import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu_torch.diff import render_soft
from opencl_ray_tracer_tpu_torch.kernels import fwd, fwd_tiled
from opencl_ray_tracer_tpu_torch.kernels import soft as B
from opencl_ray_tracer_tpu_torch.ref import render_reference
from opencl_ray_tracer_tpu_torch.utils import profiling as P
from opencl_ray_tracer_tpu_torch.utils import tracing

torch.set_num_threads(2)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 128, 64          # exactly one tile
N_PIX = W * H


@pytest.fixture(scope="module")
def scene():
    return T.Scene.build(device=CPU, sphere_origin=[[64.0, 32.0, -50.0]],
                         sphere_radius=[10.0], sphere_colour=[[0.9, 0.5, 0.2, 255.0]])


def _bytes_ms(n):
    return n / P.PEAK_HBM * 1e3


def _ops_ms(n):
    return n / P.PEAK_FP32 * 1e3


def _lit_occluded(scene, cam, cfg):
    """Lit pixels of the oracle's float frame, and those of them that the
    frame without shadows shows otherwise."""
    f = render_reference(scene, cam, cfg.replace(framebuffer_dtype="float"))
    lit = (f[..., :3] > 0).any(-1)
    if not cfg.shadows:
        return int(lit.sum()), 0
    u = render_reference(scene, cam, cfg.replace(framebuffer_dtype="float",
                                                 shadows=False))
    return int(lit.sum()), int((lit & (f != u).any(-1)).sum())


def test_bound_picks_the_larger_time():
    assert P.bound(67e9, 0) == (pytest.approx(1.0), "operations")
    assert P.bound(0, 3.35e9) == (pytest.approx(1.0), "bytes")
    assert P.bound(67e9, 6.7e9)[1] == "bytes"
    t = torch.zeros((3, 5), dtype=torch.float32)
    assert P.nbytes(t, None, t.int().to(torch.int64)) == 60 + 120
    mask = torch.zeros((70, 130), dtype=torch.bool)
    mask[0, 0] = mask[69, 129] = mask[63, 127] = True
    assert P.per_tile(mask, 2, 2).tolist() == [2, 0, 0, 1]


@pytest.mark.parametrize("shading,shadows,fmt", [("legacy", False, "packed"),
                                                 ("phong", True, "float")])
def test_b1_bound_hand_count(scene, shading, shadows, fmt):
    cam = T.legacy_ortho_camera(device=CPU)
    cfg = T.RenderConfig(width=W, height=H, shading=shading, shadows=shadows,
                         framebuffer_dtype=fmt)
    bins = fwd_tiled.bin_for_config(scene.pack(), cam, cfg)
    args, kw = fwd_tiled.kernel_inputs(scene.pack(), cam, bins, height=H, width=W,
                                       shading=shading, shadows=shadows,
                                       out_format=fmt)
    counts = args[1].tolist()
    assert counts[0][:2] == [0, 1]  # one tile, its one candidate the sphere
    lit, occ = _lit_occluded(scene, cam, cfg)
    assert lit > 200
    ops = N_PIX * 22                              # a sphere test a pixel
    if shading == "phong":
        n_sh = counts[0][3]                       # the sphere as an occluder
        assert counts[0][2] == 0 and n_sh == 1
        ops += lit * (40 + 45) + (lit - occ) * n_sh * 24 + occ * 24
    nbytes = (4 * 28 + 4 * 4 + 96 + (64 * n_sh if shading == "phong" else 0)
              + N_PIX * (4 if fmt == "packed" else 16))
    got = P.b1_bound(args, kw)
    assert got[2] == ops and got[3:] == (lit, occ)
    assert got[0] == pytest.approx(max(_ops_ms(ops), _bytes_ms(nbytes)))
    assert got[1] == ("operations" if _ops_ms(ops) >= _bytes_ms(nbytes) else "bytes")


@pytest.mark.parametrize("shading,shadows", [("legacy", False), ("phong", True)])
def test_b3_bound_hand_count(scene, shading, shadows):
    cam = T.legacy_ortho_camera(device=CPU)
    cfg = T.RenderConfig(width=W, height=H, shading=shading, shadows=shadows,
                         framebuffer_dtype="float")
    args, kw = fwd.brute_kernel_inputs(scene.pack(), cam, cfg)
    lit, occ = _lit_occluded(scene, cam, cfg)
    ops = N_PIX * 22
    if shading == "phong":
        ops += lit * (40 + 45) + (lit - occ) * 23 + occ * 23
    nbytes = P.nbytes(*args) + N_PIX * 16
    got = P.b3_bound(args, kw)
    assert got[2] == ops and got[3:] == (lit, occ)
    assert got[0] == pytest.approx(max(_ops_ms(ops), _bytes_ms(nbytes)))


def _soft_cfg(shadows):
    return T.RenderConfig(width=W, height=H, shading="lambert", shadows=shadows,
                          soft=True, framebuffer_dtype="float", tau_depth=1.0,
                          tau_edge=0.5)


def test_soft_covered(scene):
    """Covered: every pixel the soft frame shows, none far from the sphere
    (a sigmoid of -16.6 is below float32's half ulp of 1)."""
    cam = T.legacy_ortho_camera(device=CPU)
    cov = P.soft_covered(scene.pack(), cam, 0.5, H, W)
    img = render_soft(scene, cam, _soft_cfg(False))
    assert bool(cov[(img[..., :3] != 0).any(-1)].all())
    y, x = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    far = ((x - 64.0) ** 2 + (y - 32.0) ** 2).sqrt() > 10.0 + 9.0
    assert not bool(cov[far].any())
    assert 300 < int(cov.sum()) < 2000


def _cotangent():
    g = torch.zeros((H, W, 4))
    g[32, 64, 0] = 1.0    # the sphere's centre: covered
    g[0, 0, 1] = 1.0      # a corner: not covered
    g[5, 5, 3] = 1.0      # alpha: reaches nothing
    return g


@pytest.mark.parametrize("shadows", [False, True])
def test_tiled_soft_bounds_hand_count(scene, shadows):
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S

    cam = T.legacy_ortho_camera(device=CPU)
    cfg = _soft_cfg(shadows)
    with torch.no_grad():
        operands = S.soft_kernel_inputs(scene.pack(), cam, cfg)
    params, taus, tables, counts, _ = operands
    cnt = counts.tolist()[0]
    assert cnt[:2] == [0, 1]
    n_cov = int(P.soft_covered(scene.pack(), cam, 0.5, H, W).sum())
    occ_f = occ_b = 0
    if shadows:
        assert cnt[2:] == [0, 1]
        occ_f, occ_b = 8 * 64, 8 * 119          # 8 processed occluder rows
    prim_f, rest_f = 8 * 100, 60 + 70 + occ_f  # 8 processed candidate rows
    prim_b, rest_b = 8 * 169, 239 + 171 + occ_b
    ops_b4 = N_PIX * prim_f + n_cov * rest_f
    ops_b5 = 2 * (prim_f + rest_f + prim_b) + 1 * rest_b
    rows = 96 + (64 if shadows else 0)
    small = 4 * params.numel() + 4 * 2 + 4 * counts.numel()
    bytes_b4 = small + rows + N_PIX * 16
    bytes_b5 = small + N_PIX * 16 + rows + P.nbytes(params, taus, *tables)
    b4, b5, live, cov, cot = P.tiled_soft_bounds(scene, cam, cfg, operands,
                                                 _cotangent())
    assert (live, cov, cot) == (N_PIX, n_cov, 2)
    assert b4[2] == ops_b4 and b5[2] == ops_b5
    assert b4[0] == pytest.approx(max(_ops_ms(ops_b4), _bytes_ms(bytes_b4)))
    assert b5[0] == pytest.approx(max(_ops_ms(ops_b5), _bytes_ms(bytes_b5)))


@pytest.mark.parametrize("shadows", [False, True])
def test_tiled_soft_bounds_stored_finals_hand_count(scene, monkeypatch, shadows):
    """The stored-finals regime, forced through the threshold: the same
    operations as the recompute regime (the count charges B5 one forward a
    pixel either way); B4 also writes the block's rows of every pixel (6
    for lambert; 13 for lambert + soft shadows, and the light's logvis row
    of each covered pixel), B5 reads those of its two pixels."""
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S

    cam = T.legacy_ortho_camera(device=CPU)
    cfg = _soft_cfg(shadows)
    g = _cotangent()
    with torch.no_grad():
        operands = S.soft_kernel_inputs(scene.pack(), cam, cfg)
    assert not operands[4]["stored_finals"]
    recompute = P.tiled_soft_bounds(scene, cam, cfg, operands, g)
    monkeypatch.setattr(S, "_FINALS_MIN_SLOTS", 0)
    with torch.no_grad():
        operands = S.soft_kernel_inputs(scene.pack(), cam, cfg)
    params, taus, tables, counts, kc = operands
    assert kc["stored_finals"]
    n_cov = int(P.soft_covered(scene.pack(), cam, 0.5, H, W).sum())
    n_base, n_lv = (13, 1) if shadows else (6, 0)
    rows = 96 + (64 if shadows else 0)
    small = 4 * params.numel() + 4 * 2 + 4 * counts.numel()
    bytes_b4 = small + rows + N_PIX * 16 + 4 * (N_PIX * n_base + n_cov * n_lv)
    bytes_b5 = (small + N_PIX * 16 + rows + P.nbytes(params, taus, *tables)
                + 4 * (2 * n_base + 1 * n_lv))
    b4, b5, live, cov, cot = P.tiled_soft_bounds(scene, cam, cfg, operands, g)
    assert (live, cov, cot) == (N_PIX, n_cov, 2)
    assert b4[2] == recompute[0][2] and b5[2] == recompute[1][2]
    assert b4[0] == pytest.approx(max(_ops_ms(b4[2]), _bytes_ms(bytes_b4)))
    assert b5[0] == pytest.approx(max(_ops_ms(b5[2]), _bytes_ms(bytes_b5)))


def test_brute_soft_bounds_hand_count(scene):
    cam = T.legacy_ortho_camera(device=CPU)
    cfg = _soft_cfg(True)
    packed = scene.pack()
    inputs = [B._camera_params(cam, packed.lights), torch.tensor([1.0, 0.5]),
              *B._prep_soft_arrays(packed)]
    n_cov = int(P.soft_covered(packed, cam, 0.5, H, W).sum())
    # a covered pixel walks every primitive as an occluder of the one light
    prim_f, rest_f = 101, 60 + 70 + 64
    prim_b, rest_b = 176, 239 + 171 + 119
    ops_b6 = N_PIX * prim_f + n_cov * rest_f
    ops_b7 = 2 * (prim_f + rest_f + prim_b) + 1 * rest_b
    in_bytes = sum(4 * t.numel() for t in inputs)
    b6, b7, cov, cot = P.brute_soft_bounds(scene, cam, cfg, inputs, _cotangent())
    assert (cov, cot) == (n_cov, 2)
    assert b6[2] == ops_b6 and b7[2] == ops_b7
    assert b6[0] == pytest.approx(max(_ops_ms(ops_b6), _bytes_ms(in_bytes + N_PIX * 16)))
    assert b7[0] == pytest.approx(max(_ops_ms(ops_b7),
                                      _bytes_ms(2 * in_bytes + N_PIX * 16)))


def test_rays_and_sol_fraction():
    assert P.rays_per_second(1920 * 1080, 1.0) == pytest.approx(2.0736e9)
    assert P.sol_fraction(2.0, 0.5, "bytes") == {
        "bound": "bytes", "ideal_ms": 0.5, "achieved_fraction": 0.25}
    assert P.sol_fraction(0.0, 0.5, "operations")["achieved_fraction"] == 0.0


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    """A span of the port's recorder opened inside a torch profiler shows in
    the profiler's Chrome trace under the program's prefix, as a host
    operation: not a user annotation, which the profiler would mirror on
    the device's timeline."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("probe"):
            torch.ones(8).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        cats = {e.get("name"): e.get("cat") for e in json.load(f)["traceEvents"]}
    assert cats[tracing.PREFIX + "probe"] == "cpu_op"
    assert P.device_kind() is None  # no card here


def test_chip_smoke_keeps_no_bound_code():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    for name in ("_OPS", "_OPS_BWD", "PEAK_FP32 =", "PEAK_HBM =", "def _bound",
                 "def _nbytes", "def _per_tile", "def _soft_covered",
                 "def _b1_bound", "def _b3_bound", "def _tiled_soft_bounds",
                 "def _brute_soft_bounds"):
        assert name not in src, name
    assert "from opencl_ray_tracer_tpu_torch.utils import profiling as P" in src


def test_kernels_in_names_each_kernel_once():
    """The trace names of the hand-written kernels, demangled (templated or
    not) and mangled, map to their kernel; a name that only contains
    another's does not."""
    names = ["void (anonymous namespace)::fwd_tiled_kernel<false, 2, true>((anonymous "
             "namespace)::Args, int)",
             "void (anonymous namespace)::soft_brute_fwd_kernel<false, 1>(Args)",
             "_ZN46_GLOBAL__N__36cb4d3c_12soft_tiled_cu15soft_bwd_kernelILb0ELi1EEEvNS_4ArgsE",
             "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>",
             "Memcpy DtoD (Device -> Device)"]
    assert P.kernels_in(names) == {"B1/B2", "B6", "B5"}
    assert P.kernels_in(["soft_fwd_kernel_x", "my_fwd_brute_kernel"]) == set()
    assert P.kernels_in([]) == set()
    assert set(P.KERNEL_NAMES) == {"B1/B2", "B3", "B4", "B5", "B6", "B7"}
