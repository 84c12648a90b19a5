"""The eager hard frame replayed as CUDA graphs, on the card
(`kernels.fwd_tiled.render_tiled` through `runtime.graph.GraphCache`, which
captures a key at its second call).

These need an NVIDIA card and nvcc (the kernels have no CPU mode and a graph
exists only on the card), so they skip where torch.cuda.is_available() is
false. Run them on the card with:

    python -m pytest tests/test_torch_frame_replay_gpu.py -q

A replayed frame is held to the eager frame of the same K pair
(`render_tiled_packed` on `bin_for_config`'s bins) bit for bit: the same
bins and the same kernel, in every output format. tests/test_torch_frame_replay.py
holds the key rule and the bound on the graphs held on the CPU.
"""

import pytest
import torch

import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
from opencl_ray_tracer_tpu_torch.runtime import graph
from opencl_ray_tracer_tpu_torch.utils import tracing

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

pytestmark = pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs an NVIDIA card: a CUDA graph and the kernels have no CPU mode")

W, H = 640, 360


@pytest.fixture
def frames(monkeypatch):
    """A fresh cache of frame graphs and clean counters."""
    monkeypatch.setattr(fwd_tiled, "_FRAME_GRAPHS", graph.GraphCache("render_tiled"))
    tracing.reset()
    yield
    tracing.reset()


def _scene(dev):
    """rt10-like: 10 spheres and one cube."""
    return T.random_scene(10, 1, seed=11, bounds=(W, H), device=dev)


def _cameras(dev):
    """Eight cameras: five pinhole about the scene, three ortho bundles."""
    cams = []
    for i in range(5):
        cams.append(T.pinhole_camera(
            (W / 2.0 + 40.0 * i, H / 2.0 - 10.0 * i, 600.0 - 30.0 * i),
            (W / 2.0, H / 2.0, -60.0), fov_degrees=60.0, width=W, height=H,
            device=dev))
    for d in (0.0, 3.25, 11.5):
        cams.append(T.legacy_ortho_camera(device=dev).shift_subpixel(d, -d / 2))
    return cams


def _eager(scene, cam, cfg):
    packed = scene.pack()
    return fwd_tiled.render_tiled_packed(
        packed, cam, cfg, bins=fwd_tiled.bin_for_config(packed, cam, cfg))


def _counters():
    c = tracing.snapshot()["counters"]
    return {k: c.get(k, 0) for k in ("frame.eager", "frame.replayed",
                                     "frame.rebinned")}


def _pile(dev):
    """40 spheres on one spot: their tiles overflow K 32."""
    g = torch.Generator().manual_seed(9)
    n = 40
    origin = torch.cat([torch.rand(n, 2, generator=g) * 60.0 + 40.0,
                        -20.0 - 80.0 * torch.rand(n, 1, generator=g)], dim=1)
    return T.Scene.build(device=dev, sphere_origin=origin,
                         sphere_radius=5.0 + 25.0 * torch.rand(n, generator=g),
                         sphere_colour=torch.rand(n, 4, generator=g))


@pytest.mark.parametrize("fmt", ["packed", "int", "float"])
@pytest.mark.parametrize("shading,shadows", [("phong", True), ("legacy", False)])
def test_replayed_frames_equal_the_eager_frames_bit_for_bit(frames, fmt, shading,
                                                            shadows):
    dev = torch.device("cuda")
    scene = _scene(dev)
    cfg = T.RenderConfig(width=W, height=H, shading=shading, shadows=shadows,
                         framebuffer_dtype=fmt)
    cams = _cameras(dev)
    got = [fwd_tiled.render_tiled(scene, cam, cfg) for cam in cams + cams]
    for i, (cam, frame) in enumerate(zip(cams + cams, got)):
        want = _eager(scene, cam, cfg)
        assert frame.device == want.device and frame.dtype == want.dtype
        bad = (frame != want).reshape(H, W, -1).any(-1).sum().item()
        assert bad == 0, f"frame {i}: {bad} pixels differ from the eager frame"
    # pinhole and ortho are a key each: the first frame of each is eager
    assert _counters() == {"frame.eager": 2, "frame.replayed": 14,
                           "frame.rebinned": 0}
    assert tracing.counter("graph.replays.render_tiled") == 14


def test_the_first_call_is_eager_and_later_calls_replay(frames):
    dev = torch.device("cuda")
    scene, cam = _scene(dev), _cameras(dev)[0]
    cfg = T.RenderConfig(width=W, height=H, shading="phong", shadows=True,
                         framebuffer_dtype="packed")
    seen = []
    for _ in range(4):
        fwd_tiled.render_tiled(scene, cam, cfg)
        seen.append((_counters()["frame.eager"], _counters()["frame.replayed"]))
    assert seen == [(1, 0), (1, 1), (1, 2), (1, 3)]
    assert tracing.counter("graph.capture_s") > 0
    # the scene's tensors changed in place are read by the next replay
    moved = _scene(dev)
    moved.sphere_origin[:, 0] += 25.0
    scene.sphere_origin.copy_(moved.sphere_origin)
    assert torch.equal(fwd_tiled.render_tiled(scene, cam, cfg),
                       _eager(moved, cam, cfg))


def test_an_overflowing_scene_rebins_through_the_doubled_pair(frames):
    dev = torch.device("cuda")
    scene, cam = _pile(dev), T.legacy_ortho_camera(device=dev)
    w, h = 256, 128
    cfg = T.RenderConfig(width=w, height=h, shading="legacy",
                         framebuffer_dtype="packed")
    assert bool(fwd_tiled.bin_scene(scene.pack(), height=h, width=w,
                                    k=cfg.cull_k).overflow)
    want = _eager(scene, cam, cfg)
    for n in range(4):
        assert torch.equal(fwd_tiled.render_tiled(scene, cam, cfg), want), n
    # eager at K 32, whose flag reads true, and eager at K 40; then both
    # pairs are captured and replay, three times
    assert _counters() == {"frame.eager": 1, "frame.replayed": 3,
                           "frame.rebinned": 4}


def test_two_frames_in_a_row_do_not_alias(frames):
    dev = torch.device("cuda")
    scene = _scene(dev)
    a_cam, b_cam = _cameras(dev)[:2]
    cfg = T.RenderConfig(width=W, height=H, shading="phong", shadows=True,
                         framebuffer_dtype="float")
    fwd_tiled.render_tiled(scene, a_cam, cfg)  # eager: the key is seen
    a = fwd_tiled.render_tiled(scene, a_cam, cfg)
    kept = a.clone()
    b = fwd_tiled.render_tiled(scene, b_cam, cfg)
    assert _counters()["frame.replayed"] == 2
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, kept) and not torch.equal(a, b)


def test_overflow_at_the_full_k_raises_eager_and_replayed(frames, monkeypatch):
    real = fwd_tiled.bin_scene

    def always_over(*a, **k):
        bins = real(*a, **k)
        bins.overflow = torch.ones_like(bins.overflow)
        return bins

    monkeypatch.setattr(fwd_tiled, "bin_scene", always_over)
    dev = torch.device("cuda")
    scene, cam = _scene(dev), _cameras(dev)[0]
    cfg = T.RenderConfig(width=W, height=H, shading="phong", shadows=True,
                         framebuffer_dtype="packed")
    for _ in range(3):  # eager, the capture's replay, a replay
        with pytest.raises(RuntimeError, match="full K"):
            fwd_tiled.render_tiled(scene, cam, cfg)
    assert tracing.counter("graph.replays.render_tiled") == 2
