"""The eager hard frame replayed as CUDA graphs (`kernels.fwd_tiled.render_tiled`
through `runtime.graph.GraphCache`), on the CPU.

CPU tensors never capture: every frame is eager and is today's frame. The
key rule (seen once: eager; twice: capture; then replay), the bound on the
graphs held, the re-binning at the doubled K pair and the frames' ownership
are held here with a stand-in for `runtime.graph.capture` that runs the
function on the CPU and writes its outputs anew at every replay, as a CUDA
graph writes its static outputs, and a null `torch.cuda.device`. tests/test_torch_frame_replay_gpu.py holds
the same on the card with real graphs.
"""

import contextlib

import pytest
import torch

import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
from opencl_ray_tracer_tpu_torch.runtime import graph
from opencl_ray_tracer_tpu_torch.utils import tracing

torch.set_num_threads(2)

W, H = 256, 128  # 2 x 2 tiles


class _StandInGraph:
    """Runs `fn` again at every replay and copies its tensors into the
    outputs of the first call, as a CUDA graph's replay rewrites its static
    outputs."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        new: list = []
        old: list = []
        graph._flatten(self.fn(), new)
        graph._flatten(self.out, old)
        for o, n in zip(old, new):
            o.copy_(n)


@pytest.fixture
def captures(monkeypatch):
    """The stand-in capture on CPU tensors, a fresh cache of frame graphs
    and clean counters; yields the list of captured names."""
    names = []

    def capture(fn, *, warmup=2, name=""):
        names.append(name)
        out = fn()
        return _StandInGraph(fn, out), out

    monkeypatch.setattr(graph, "capture", capture)
    monkeypatch.setattr(graph, "_on_card", lambda leaves: True)
    monkeypatch.setattr(graph.torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(fwd_tiled, "_FRAME_GRAPHS",
                        graph.GraphCache("render_tiled", 8))
    tracing.reset()
    yield names
    tracing.reset()


@pytest.fixture
def clean(monkeypatch):
    monkeypatch.setattr(fwd_tiled, "_FRAME_GRAPHS",
                        graph.GraphCache("render_tiled", 8))
    tracing.reset()
    yield
    tracing.reset()


def _scene():
    return T.random_scene(10, 1, seed=5, bounds=(W, H), device="cpu")


def _cameras():
    """Six cameras: pinhole about the scene and shifted ortho bundles."""
    cams = []
    for i in range(4):
        cams.append(T.pinhole_camera(
            (W / 2.0 + 20.0 * i, H / 2.0 - 5.0 * i, 220.0 + 10.0 * i),
            (W / 2.0, H / 2.0, -60.0), fov_degrees=60.0, width=W, height=H,
            device="cpu"))
    for dx in (0.0, 7.5):
        o = T.legacy_ortho_camera(device="cpu")
        cams.append(o.shift_subpixel(dx, -dx))
    return cams


def _config(fmt, **kw):
    return T.RenderConfig(width=W, height=H, shading="phong", shadows=True,
                          framebuffer_dtype=fmt, **kw)


def _eager(scene, cam, cfg):
    packed = scene.pack()
    return fwd_tiled.render_tiled_packed(
        packed, cam, cfg, bins=fwd_tiled.bin_for_config(packed, cam, cfg))


def _counters():
    c = tracing.snapshot()["counters"]
    return {k: c.get(k, 0) for k in ("frame.eager", "frame.replayed",
                                     "frame.rebinned")}


def _pile():
    """40 spheres on one spot: their tiles overflow K 32 (and 16, 8)."""
    g = torch.Generator().manual_seed(9)
    n = 40
    origin = torch.cat([torch.rand(n, 2, generator=g) * 60.0 + 40.0,
                        -20.0 - 80.0 * torch.rand(n, 1, generator=g)], dim=1)
    return T.Scene.build(device="cpu", sphere_origin=origin,
                         sphere_radius=5.0 + 25.0 * torch.rand(n, generator=g),
                         sphere_colour=torch.rand(n, 4, generator=g))


@pytest.mark.parametrize("fmt", ["packed", "int", "float"])
def test_cpu_frames_never_capture_and_are_todays(clean, monkeypatch, fmt):
    def no_capture(*a, **k):
        raise AssertionError("a CPU frame captured")

    monkeypatch.setattr(graph, "capture", no_capture)
    scene, cfg = _scene(), _config(fmt)
    cams = _cameras()
    for cam in cams + cams[:2]:
        got = fwd_tiled.render_tiled(scene, cam, cfg)
        assert torch.equal(got, _eager(scene, cam, cfg))
    assert _counters() == {"frame.eager": 8, "frame.replayed": 0,
                           "frame.rebinned": 0}
    assert not fwd_tiled._FRAME_GRAPHS.held


def test_key_rule_seen_once_eager_twice_captured_then_replayed(captures):
    cache = graph.GraphCache("probe", 8)
    calls = []

    def fn(x, scale=2.0):
        calls.append(1)
        return x * scale

    x = torch.arange(4.0)
    assert cache("k", fn, x) is None and not captures and not calls
    out = cache("k", fn, x)
    assert captures == ["probe"] and torch.equal(out, x * 2)
    x2 = torch.arange(4.0) + 10
    again = cache("k", fn, x2)
    assert again is out and torch.equal(out, x2 * 2)  # the static output
    assert captures == ["probe"]
    assert tracing.counter("graph.replays.probe") == 2
    # a new shape, dtype, static value or key is a key of its own
    for args in ((torch.arange(5.0),), (torch.arange(4),), (x, 3.0)):
        assert cache("k", fn, *args) is None
    assert cache("other", fn, x) is None
    assert captures == ["probe"]


def test_the_held_keys_are_bounded_least_recent_first_out(captures):
    cache = graph.GraphCache("probe", 2)
    fn = lambda x: x + 1  # noqa: E731
    x = torch.zeros(3)
    for key in ("a", "a", "b", "b"):
        cache(key, fn, x)
    assert captures == ["probe", "probe"]
    cache("a", fn, x)               # a is now the most recent
    assert cache("c", fn, x) is None  # b goes
    assert list(k[0] for k in cache.held) == ["a", "c"]
    assert cache("b", fn, x) is None  # seen once again; a goes
    assert cache("c", fn, x) is not None
    assert len(cache.held) == 2 and captures == ["probe"] * 3


def test_cpu_tensors_are_never_held(clean, monkeypatch):
    monkeypatch.setattr(graph, "capture", None)  # never called
    cache = graph.GraphCache("probe", 2)
    for _ in range(3):
        assert cache("k", lambda x: x + 1, torch.zeros(3)) is None
    assert not cache.held


@pytest.mark.parametrize("fmt", ["packed", "int", "float"])
def test_replayed_frames_match_the_eager_frames_bit_for_bit(captures, fmt):
    scene, cfg = _scene(), _config(fmt)
    cams = _cameras()
    frames = [fwd_tiled.render_tiled(scene, cam, cfg) for cam in cams]
    for cam, got in zip(cams, frames):
        assert torch.equal(got, _eager(scene, cam, cfg))
    # the pinhole and ortho cameras are keys of their own (Camera.normalize)
    assert captures == ["render_tiled", "render_tiled"]
    assert _counters() == {"frame.eager": 2, "frame.replayed": 4,
                           "frame.rebinned": 0}
    assert tracing.counter("graph.replays.render_tiled") == 4


def test_an_overflowing_scene_rebins_through_the_doubled_pair(captures):
    scene, cam = _pile(), T.legacy_ortho_camera(device="cpu")
    cfg = T.RenderConfig(width=W, height=H, shading="legacy",
                         framebuffer_dtype="packed")
    packed = scene.pack()
    assert bool(fwd_tiled.bin_scene(packed, height=H, width=W,
                                    k=cfg.cull_k).overflow)
    want = _eager(scene, cam, cfg)
    # eager at K 32 (re-binned to 40); then the replay at K 32 overflows and
    # K 40 is new: eager there; then both pairs replay
    for n in range(3):
        assert torch.equal(fwd_tiled.render_tiled(scene, cam, cfg), want), n
    assert _counters() == {"frame.eager": 2, "frame.replayed": 1,
                           "frame.rebinned": 3}
    assert captures == ["render_tiled", "render_tiled"]
    assert [k[0][1:] for k in fwd_tiled._FRAME_GRAPHS.held] == [(32, 64), (40, 64)]


def test_two_frames_in_a_row_do_not_alias(captures):
    scene, cfg = _scene(), _config("float")
    a_cam, b_cam = _cameras()[:2]
    fwd_tiled.render_tiled(scene, a_cam, cfg)  # eager: the key is seen
    a = fwd_tiled.render_tiled(scene, a_cam, cfg)
    kept = a.clone()
    b = fwd_tiled.render_tiled(scene, b_cam, cfg)
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, kept) and not torch.equal(a, b)
    static = fwd_tiled._FRAME_GRAPHS.held[next(iter(fwd_tiled._FRAME_GRAPHS.held))]
    assert static.outputs[0].data_ptr() not in (a.data_ptr(), b.data_ptr())


def test_overflow_at_the_full_k_raises_eager_and_replayed(captures, monkeypatch):
    real = fwd_tiled.bin_scene

    def always_over(*a, **k):
        bins = real(*a, **k)
        bins.overflow = torch.ones_like(bins.overflow)
        return bins

    monkeypatch.setattr(fwd_tiled, "bin_scene", always_over)
    scene, cam = _scene(), _cameras()[0]
    cfg = _config("packed")
    for _ in range(3):  # eager, then through the captured pairs
        with pytest.raises(RuntimeError, match="full K"):
            fwd_tiled.render_tiled(scene, cam, cfg)
    assert captures  # the replays reached the full K too
