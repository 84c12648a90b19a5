"""The port's one holder of CUDA graphs (`runtime.graph.GraphCache`) under
its two capture rules, `jit`'s and the hard frame's, and the hard frame
replayed through it (`kernels.fwd_tiled.render_tiled`), on the CPU.

CPU tensors never capture: every frame is eager and is today's frame. The
key rule (captured at a key's first call for `jit`; run as it is at the
first call and captured at the second for the frame; then replayed), the
bound on the keys held, the re-binning at the doubled K pair and the
frames' ownership are held here with a stand-in for `runtime.graph.capture`
that runs the function on the CPU and writes its outputs anew at every
replay, as a CUDA graph writes its static outputs, the CPU taken for a
card (`runtime.graph._card`) and a null `torch.cuda.device`.
tests/test_torch_frame_replay_gpu.py holds the same on the card with real
graphs.
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
    monkeypatch.setattr(graph, "_card", lambda leaves: torch.device("cpu"))
    monkeypatch.setattr(graph.torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(fwd_tiled, "_FRAME_GRAPHS", graph.GraphCache("render_tiled"))
    tracing.reset()
    yield names
    tracing.reset()


@pytest.fixture
def clean(monkeypatch):
    monkeypatch.setattr(fwd_tiled, "_FRAME_GRAPHS", graph.GraphCache("render_tiled"))
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


# the two capture rules: jit's (a key's first call) and the frame's (its second)
RULES = [1, 2]


@pytest.mark.parametrize("capture_at", RULES)
def test_key_rule_seen_once_eager_twice_captured_then_replayed(captures, capture_at):
    cache = graph.GraphCache("probe", capture_at)

    def fn(x, scale=2.0):
        return x * scale

    x = torch.arange(4.0)
    for _ in range(capture_at - 1):  # before the capture: fn as it is
        out, replayed = cache("k", fn, x)
        assert not replayed and torch.equal(out, x * 2) and not captures
    out, replayed = cache("k", fn, x)
    assert replayed and captures == ["probe"] and torch.equal(out, x * 2)
    x2 = torch.arange(4.0) + 10
    again, replayed = cache("k", fn, x2)
    assert replayed and again is out and torch.equal(out, x2 * 2)  # the static output
    assert captures == ["probe"]
    assert tracing.counter("graph.replays.probe") == 2
    # a new shape, dtype, static value or key is a key of its own
    for key, args in (("k", (torch.arange(5.0),)), ("k", (torch.arange(4),)),
                      ("k", (x, 3.0)), ("other", (x,))):
        got, replayed = cache(key, fn, *args)
        assert torch.equal(got, fn(*args)) and replayed == (capture_at == 1), key
    assert captures == ["probe"] * (5 if capture_at == 1 else 1)


@pytest.mark.parametrize("capture_at", RULES)
def test_the_held_keys_are_bounded_least_recent_first_out(captures, capture_at):
    cache = graph.GraphCache("probe", capture_at)
    assert cache.size == 8
    cache.size = 2
    fn = lambda x: x + 1  # noqa: E731
    x = torch.zeros(3)
    for key in ("a", "a", "b", "b"):
        assert torch.equal(cache(key, fn, x)[0], x + 1)
    assert captures == ["probe", "probe"]
    assert cache("a", fn, x)[1]            # a is now the most recent
    assert cache("c", fn, x)[1] == (capture_at == 1)  # b goes
    assert list(k[0] for k in cache.held) == ["a", "c"]
    assert cache("b", fn, x)[1] == (capture_at == 1)  # held anew; a goes
    assert cache("c", fn, x)[1]
    assert len(cache.held) == 2
    assert captures == ["probe"] * (4 if capture_at == 1 else 3)


@pytest.mark.parametrize("capture_at", RULES)
def test_cpu_tensors_are_never_held(clean, monkeypatch, capture_at):
    monkeypatch.setattr(graph, "capture", None)  # never called
    cache = graph.GraphCache("probe", capture_at)
    for _ in range(3):
        out, replayed = cache("k", lambda x: x + 1, torch.zeros(3))
        assert not replayed and torch.equal(out, torch.ones(3))
    assert not cache.held


def test_jit_holds_at_most_eight_keys(captures):
    f = graph.jit(lambda x, *, n: x * float(n), static=("n",))
    for n in range(10):
        x = torch.arange(float(n + 1))
        assert torch.equal(f(x, n=n), x * float(n))
    assert captures == ["<lambda>"] * 10
    # the least recently used keys went first, with their graphs
    assert [k[0] for k in f.graphs.held] == [(("n", n),) for n in range(2, 10)]
    assert torch.equal(f(torch.ones(10), n=9), torch.full((10,), 9.0))
    assert captures == ["<lambda>"] * 10  # a held key replays


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
    # eager at K 32, whose flag reads true, and eager at K 40; then both
    # pairs are captured and replay, twice
    for n in range(3):
        assert torch.equal(fwd_tiled.render_tiled(scene, cam, cfg), want), n
    assert _counters() == {"frame.eager": 1, "frame.replayed": 2,
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
