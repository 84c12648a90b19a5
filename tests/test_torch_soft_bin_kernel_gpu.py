"""The soft frame's binning kernels (kernels/csrc/bin_tiled.cu:
bin_soft_prep_kernel, bin_soft_tiles_kernel) against their plain twin, on
the card.

These need an NVIDIA card and nvcc (the kernels have no CPU mode), so they
skip where torch.cuda.is_available() is false. Run them on the card with:

    python -m pytest --noconftest tests/test_torch_soft_bin_kernel_gpu.py -q

`soft_tiled._bin_soft` on CUDA tensors launches the kernels
(`_bin_soft_cuda`); `_bin_soft_plain`, the twin that CPU tensors run, is
run here on the same CUDA tensors. SoftBins holds only lists, masks, counts
and the overflow flag, all from comparisons of values that both sides round
alike, so every field must be equal: the ortho cases bit for bit by
construction (the same float32 operations in the same order); a pinhole
box's projection inverts the camera matrix in double where the twin uses
float32 LAPACK and cuBLAS, which may round a corner an ulp apart, so its
lists are equal unless a box edge lies within ulps of a tile's edge, which
these scenes do not place there.
"""

import pytest
import torch

import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
from opencl_ray_tracer_tpu_torch.parallel.mesh import shift_camera_rows
from opencl_ray_tracer_tpu_torch.parallel.train import scene_leaves, trainable_scene
from opencl_ray_tracer_tpu_torch.runtime import graph
from opencl_ray_tracer_tpu_torch.scene.scene import Lights
from opencl_ray_tracer_tpu_torch.utils import tracing

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

pytestmark = pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs an NVIDIA card: the CUDA kernels have no CPU mode")

FIELDS = ("t_idx", "t_valid", "s_idx", "s_valid", "tsh_idx", "tsh_valid",
          "ssh_idx", "ssh_valid", "counts", "overflow")
STATIC = ("k_tri", "k_sph", "k_sh_tri", "k_sh_sph", "nty", "ntx", "projective")


def lights(n, dev):
    """n point lights (n = 1: the benchmark's light, the port's default)."""
    if n == 1:
        return Lights.default(dev)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    pos = [[200.0, 100.0, 200.0], [1500.0, 800.0, 150.0]]
    return Lights(position=f(pos[:n]), colour=f([[1.0, 0.9, 0.8]] * n),
                  intensity=f([0.6] * n), ambient=f(0.1),
                  spec_strength=f(0.5), shininess=f(32.0))


def scene(kind, n_lights, dev):
    """rt10: the rt10_1080 configuration's 10 spheres and a cube over
    1910 x 1070; scene3: scene 3's 100 spheres and 100 cubes there; scene3_4k:
    the same over 3830 x 2150; spheres / triangles: one kind only; pile: 40
    spheres on one spot, whose tiles overflow K 32."""
    lt = lights(n_lights, dev)
    if kind == "rt10":
        return T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), lights=lt, device=dev)
    if kind == "scene3":
        return T.random_scene(100, 100, seed=0, bounds=(1910.0, 1070.0), lights=lt,
                              device=dev)
    if kind == "scene3_4k":
        return T.random_scene(100, 100, seed=0, bounds=(3830.0, 2150.0), lights=lt,
                              device=dev)
    if kind == "spheres":
        return T.random_scene(12, 0, seed=5, bounds=(1910.0, 1070.0), lights=lt, device=dev)
    if kind == "triangles":
        return T.random_scene(0, 3, seed=7, bounds=(1910.0, 1070.0), lights=lt, device=dev)
    g = torch.Generator().manual_seed(9)
    n = 40
    origin = torch.cat([torch.rand(n, 2, generator=g) * 60.0 + 40.0,
                        -20.0 - 80.0 * torch.rand(n, 1, generator=g)], dim=1)
    return T.Scene.build(device=dev, sphere_origin=origin,
                         sphere_radius=5.0 + 25.0 * torch.rand(n, generator=g),
                         sphere_colour=torch.rand(n, 4, generator=g), lights=lt)


def camera(kind, dev, width, height):
    """ortho (the reference's); subpixel (its origin offset by sub-pixels);
    rank2 (the ortho camera shifted to row 1080, rank 2's block of the
    4-card 4K fit); pinhole (looking at the frame from in front of it)."""
    if kind == "ortho":
        return T.legacy_ortho_camera(device=dev)
    if kind == "subpixel":
        return T.legacy_ortho_camera(device=dev).shift_subpixel(3.25, -1.625)
    if kind == "rank2":
        return shift_camera_rows(T.legacy_ortho_camera(device=dev), 2 * height)
    return T.pinhole_camera((width / 2.0, height / 2.0, 1200.0),
                            (width / 2.0 + 20.0, height / 2.0 - 10.0, -200.0),
                            fov_degrees=60.0, width=width, height=height, device=dev)


# (scene, camera, shadows, lights, K, shadow K, width, height, tau_edge)
CASES = [
    ("rt10", "ortho", True, 1, 32, 64, 1920, 1080, 0.5),      # rt10_1080.fit
    ("scene3", "ortho", True, 1, 96, 136, 1920, 1080, 0.5),   # scene3_1080.fit
    ("scene3_4k", "rank2", True, 1, 96, 136, 3840, 540, 0.5),  # a rank of fit4
    ("rt10", "ortho", False, 1, 32, 64, 1920, 1080, 0.5),
    ("rt10", "ortho", True, 2, 32, 64, 1920, 1080, 0.5),
    ("scene3", "ortho", True, 2, 96, 136, 1920, 1080, 2.0),
    ("rt10", "subpixel", True, 1, 32, 64, 1920, 1080, 3.0),
    ("rt10", "pinhole", True, 1, 32, 64, 1920, 1080, 0.5),
    ("rt10", "pinhole", False, 2, 32, 64, 1920, 1080, 0.5),
    ("scene3", "pinhole", True, 1, 96, 136, 1920, 1080, 0.5),
    ("spheres", "ortho", True, 2, 32, 64, 1920, 1080, 0.5),
    ("triangles", "ortho", True, 1, 32, 64, 1920, 1080, 0.5),
    ("triangles", "pinhole", True, 1, 32, 64, 1920, 1080, 0.5),
    ("pile", "ortho", True, 1, 32, 16, 256, 128, 0.5),
    ("pile", "pinhole", True, 1, 32, 64, 256, 128, 0.5),
]


def case_inputs(case, dev):
    """(packed scene, camera, _bin_soft's keywords, tau_edge) of a case."""
    kind, cam_kind, shadows, n_lights, k, shadow_k, w, h, tau = case
    return (scene(kind, n_lights, dev).pack(), camera(cam_kind, dev, w, h),
            dict(height=h, width=w, k=k, shadows=shadows, shadow_k=shadow_k), tau)


def twin(packed, tau, cam, kw):
    """`_bin_soft_plain` at `_bin_soft`'s caps, on the scene's device."""
    sizes = S._soft_bin_sizes(packed, projective=cam.normalize, **kw)
    return S._bin_soft_plain(packed, graph.device_scalar(tau, packed.device), cam,
                             **sizes)


def compare_bins(got, want):
    for f in STATIC:
        assert getattr(got, f) == getattr(want, f), f
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, (f, g.shape, w.shape)
        assert torch.equal(g, w), f


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_kernels_match_the_twin(case):
    tracing.reset()
    packed, cam, kw, tau = case_inputs(case, torch.device("cuda"))
    got = S._bin_soft(packed, tau, cam, **kw)
    assert tracing.counter("launch.bin_soft") == 1
    want = twin(packed, tau, cam, kw)
    torch.cuda.synchronize()
    compare_bins(got, want)
    caps = torch.tensor([got.k_tri, got.k_sph] + [got.k_sh_tri, got.k_sh_sph]
                        * packed.lights.position.shape[0], device=got.counts.device)
    assert bool((got.counts <= caps).all())
    if case[0] == "pile":
        assert bool(got.overflow)
    if case in CASES[:2]:  # the fit cells' frames take the tiled branch
        assert not bool(got.overflow)
    assert int(got.counts[:, :2].sum()) > 0


def test_a_captured_binning_follows_tau_edge():
    """One captured `_bin_soft` replayed at two tau_edge values written into
    its scalar: each replay's bins are the twin's at that value, and the
    two differ (the pad moves the lists)."""
    dev = torch.device("cuda")
    packed, cam, kw, _ = case_inputs(CASES[0], dev)
    tau = torch.tensor(0.5, dtype=torch.float32, device=dev)
    S._bin_soft(packed, tau, cam, **kw)  # the build, outside the capture
    torch.cuda.synchronize()
    tracing.reset()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        bins = S._bin_soft(packed, tau, cam, **kw)
    assert tracing.counter("launch.bin_soft") == 0
    seen = []
    for value in (0.5, 4.0):
        tau.fill_(value)
        g.replay()
        torch.cuda.synchronize()
        compare_bins(bins, twin(packed, value, cam, kw))
        seen.append(bins.counts.clone())
    assert not torch.equal(seen[0], seen[1])
    assert int(seen[1].sum()) > int(seen[0].sum())


@pytest.mark.parametrize("cam_kind", ["ortho", "pinhole"])
def test_captured_core_step_matches_the_twin_binned_eager_step(monkeypatch, cam_kind):
    """`_soft_tiled_core` and the gradient of a loss, captured with the
    kernels' bins and replayed, against the same eager step whose bins come
    from the twin: image equal bit for bit (the same bins, tables and B4);
    every leaf gradient within 1e-3 of its largest magnitude, the bar the
    card tests hold two runs of B5 to (test_torch_kernels_gpu.py,
    test_soft_core_stored_finals_branches): B5 and the tables' reverse sum
    with atomics in no fixed order, and a leaf summed near zero shows it
    (8e-5 to 1.4e-4 of the largest on an H100, as two eager runs differ).
    The gap between two eager runs of the step is printed beside the
    replay's."""
    dev = torch.device("cuda")
    w, h = 640, 480
    sc = trainable_scene(T.random_scene(10, 1, seed=3, bounds=(630.0, 470.0),
                                        device=dev))
    cam = camera(cam_kind, dev, w, h)
    leaves = list(scene_leaves(sc).values())
    tau_d = torch.tensor(1.0, dtype=torch.float32, device=dev)
    tau_e = torch.tensor(0.5, dtype=torch.float32, device=dev)

    def step():
        img = S._soft_tiled_core(sc.pack(), cam, tau_d, tau_e, h, w, "phong",
                                 True, 32, 64)
        grads = torch.autograd.grad((img[..., :3] ** 2).mean(), leaves,
                                    allow_unused=True)
        return [img.detach()] + [torch.zeros_like(v) if gr is None else gr
                                 for v, gr in zip(leaves, grads)]

    tracing.reset()
    graph_, out = graph.capture(step, name="soft bin test step")
    launched = tracing.counter("launch.bin_soft")
    assert launched == 2  # the two warm-up runs; the capture counts none
    graph.replay(graph_, "soft bin test step")
    torch.cuda.synchronize()
    assert tracing.counter("launch.bin_soft") == launched
    got = [t.clone() for t in out]

    monkeypatch.setattr(S, "_bin_soft_cuda", lambda packed, tau, c, **sz:
                        S._bin_soft_plain(packed, tau, c, **sz))
    want = step()
    again = step()
    torch.cuda.synchronize()
    assert tracing.counter("launch.bin_soft") == launched
    assert torch.equal(got[0], want[0]), "image"
    assert torch.equal(again[0], want[0]), "image of a second eager step"
    assert float(want[0][..., :3].abs().max()) > 0

    def gap(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    replayed = [gap(a, b) for a, b in zip(got[1:], want[1:])]
    eager = [gap(a, b) for a, b in zip(again[1:], want[1:])]
    print(f"[soft bin step] {cam_kind}: leaf gradient gaps, replay against "
          f"eager {max(replayed):.3e}, eager against eager {max(eager):.3e}, "
          "of each leaf's largest")
    for i, g in enumerate(replayed):
        assert g <= 1e-3, (i, g)
