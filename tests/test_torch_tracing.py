"""The port's recorder of spans and counters (`utils.tracing`): off by
default and then free of records, the hard frame's spans nested as its
layers are, the same spans in a torch profiler's trace, counters, device
counters and the set-up counters."""

import time

import pytest
import torch

import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu_torch.models.renderer import render
from opencl_ray_tracer_tpu_torch.parallel.train import adam, init_train_state
from opencl_ray_tracer_tpu_torch.runtime import graph
from opencl_ray_tracer_tpu_torch.utils import tracing

torch.set_num_threads(2)

W, H = 128, 64
FRAME_SPANS = ("frame.pack", "frame.bin", "frame.bin.host_read", "frame.gather")


@pytest.fixture(autouse=True)
def clean():
    tracing.reset()
    yield
    tracing.reset()


def _frame():
    """A CPU frame of scene 1 through a pinhole camera, on the tiled path
    (the kernels' plain twins)."""
    scene = T.create_scene1(device="cpu")
    cam = T.pinhole_camera((W / 2.0, H / 2.0, 300.0), (W / 2.0, H / 2.0, -85.0),
                           fov_degrees=60.0, width=W, height=H, device="cpu")
    cfg = T.RenderConfig(width=W, height=H, shading="phong", shadows=True,
                         framebuffer_dtype="packed")
    return render(scene, cam, cfg, backend="pallas")


def test_off_span_is_one_shared_null_and_records_nothing():
    assert tracing.span("frame.bin") is tracing.span("graph.replay")
    with tracing.span("frame.bin") as s:
        assert s is None
    _frame()
    snap = tracing.snapshot()
    assert snap["spans"] == {} and tracing.recent() == []
    assert tracing._totals == {} and tracing._open() == []
    # a CPU frame launches no kernel; device counters made earlier read 0
    assert not any(snap["counters"].values())


def test_recording_a_cpu_frame_nests_its_spans():
    with tracing.recording():
        out = _frame()
    assert out.shape == (H, W)
    spans = tracing.snapshot()["spans"]
    assert set(spans) == set(FRAME_SPANS)
    for name in ("frame.pack", "frame.bin", "frame.gather"):
        assert spans[name]["count"] == 1, name
    assert spans["frame.bin.host_read"]["count"] >= 1
    for name, s in spans.items():
        assert 0.0 < s["self_s"] <= s["total_s"], name
    # frame.bin holds the host read and nothing else; the others hold no span
    b, read = spans["frame.bin"], spans["frame.bin.host_read"]
    assert b["total_s"] - b["self_s"] == pytest.approx(read["total_s"], abs=1e-9)
    for name in ("frame.pack", "frame.gather", "frame.bin.host_read"):
        assert spans[name]["self_s"] == spans[name]["total_s"], name
    # tracing is off again after the block
    assert tracing.span("frame.bin") is tracing.span("frame.pack")


def test_spans_under_the_profiler_share_its_clock():
    """Under a CPU torch.profiler each span is also a profiler range named
    "octrt.<span>", and the recorder's interval lies in the range's (mapped
    from the monotonic clock to the profiler's wall clock)."""
    offset = time.time_ns() - time.perf_counter_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _frame()
    base = prof.profiler.kineto_results.trace_start_ns()
    ranges = {}
    for e in prof.events():
        if e.name.startswith(tracing.PREFIX):
            ranges.setdefault(e.name[len(tracing.PREFIX):], []).append(
                (base + e.time_range.start * 1e3, base + e.time_range.end * 1e3))
    recorded = {}
    for name, a, b, _ in tracing.recent():
        recorded.setdefault(name, []).append((a + offset, b + offset))
    assert set(ranges) == set(recorded) == set(FRAME_SPANS)
    tol = 5e5  # ns: reading two clocks, and the profiler's rounding to us
    for name, rec in recorded.items():
        assert len(rec) == len(ranges[name]), name
        for (a, b), (pa, pb) in zip(sorted(rec), sorted(ranges[name])):
            assert pa - tol <= a <= b <= pb + tol, (name, a, b, pa, pb)
            assert max(a, pa) < min(b, pb) + tol


def test_without_the_fast_range_spans_are_recorded_and_open_no_range(monkeypatch):
    """On a torch without `_RecordFunctionFast` a span under the profiler
    is recorded as before and opens no profiler range."""
    monkeypatch.setattr(tracing, "_range_op", False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _frame()
    assert not [e for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    assert set(tracing.snapshot()["spans"]) == set(FRAME_SPANS)


def test_recent_keeps_the_parent_names_and_is_bounded():
    with tracing.recording():
        _frame()
        parents = {name: parent for name, _, _, parent in tracing.recent()}
        assert parents == {"frame.pack": None, "frame.bin": None,
                           "frame.bin.host_read": "frame.bin",
                           "frame.gather": None}
        for _ in range(tracing.RECENT + 10):
            with tracing.span("probe"):
                pass
    assert len(tracing.recent()) == tracing.RECENT
    assert tracing.snapshot()["spans"]["probe"]["count"] == tracing.RECENT + 10


def test_open_spans_are_each_threads_own():
    """A span open in one thread is not the parent of another thread's, and
    does not hold back `reset` there."""
    import threading

    opened, release = threading.Event(), threading.Event()

    def other():
        with tracing.span("other"):
            opened.set()
            release.wait(10)

    with tracing.recording():
        t = threading.Thread(target=other)
        t.start()
        assert opened.wait(10)
        with tracing.span("mine"):
            pass
        assert tracing.recent() == [r for r in tracing.recent() if r[3] is None]
        tracing.reset()
        release.set()
        t.join()
    spans = tracing.snapshot()["spans"]
    assert set(spans) == {"other"} and spans["other"]["self_s"] > 0


@pytest.mark.parametrize("adds,total", [((1,), 1), ((1, 1, 1), 3), ((2.5, 0.5), 3.0)])
def test_counters_add_and_reset_clears_them(adds, total):
    for n in adds:
        tracing.count("probe", n)
    assert tracing.counter("probe") == total
    assert tracing.snapshot()["counters"]["probe"] == total
    tracing.reset()
    assert tracing.counter("probe") == 0
    assert "probe" not in tracing.snapshot()["counters"]


def test_device_counter_is_read_on_the_host_and_zeroed_by_reset():
    assert tracing.device_counter("cond.probe.brute", "cpu", make=False) is None
    slot = tracing.device_counter("cond.probe.brute", "cpu")
    assert slot.dtype == torch.int64 and slot.shape == (1,)
    assert tracing.device_counter("cond.probe.brute", "cpu") is slot
    slot += 3  # what set_branches adds on the card, replay by replay
    tracing.count("cond.probe.brute", 1)
    assert tracing.counter("cond.probe.brute") == 4
    assert tracing.snapshot()["counters"]["cond.probe.brute"] == 4
    tracing.reset()
    assert int(slot) == 0 and tracing.counter("cond.probe.brute") == 0


def test_reset_inside_a_span_raises():
    with tracing.recording():
        with tracing.span("frame.bin"):
            with pytest.raises(RuntimeError, match="frame.bin"):
                tracing.reset()
    assert tracing.snapshot()["spans"]["frame.bin"]["count"] == 1


def test_an_eager_cond_counts_nothing():
    x = torch.arange(4.0)
    out = graph.cond(torch.tensor(True), lambda v, run_if=None: v + 1,
                     lambda v, run_if=None: v - 1, (x,), site="eager_probe")
    assert torch.equal(out, x + 1)
    assert "cond.eager_probe.brute" not in tracing.snapshot()["counters"]
    assert tracing.device_counter("cond.eager_probe.brute", "cpu",
                                  make=False) is None


def test_init_train_state_counts_the_optimizer_seconds():
    init_train_state(T.create_scene1(device="cpu"), adam(0.1))
    first = tracing.counter("train.optimizer_s")
    assert first > 0
    init_train_state(T.create_scene1(device="cpu"), adam(0.1))
    assert tracing.counter("train.optimizer_s") > first
