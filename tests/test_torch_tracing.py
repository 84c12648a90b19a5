"""The port's recorder of spans and counters (`utils.tracing`): off by
default and then free of records, the hard frame's spans nested as its
layers are, the same spans in a torch profiler's trace, counters, device
counters and the set-up counters."""

import time

import pytest
import torch

import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
from opencl_ray_tracer_tpu_torch.models.renderer import render
from opencl_ray_tracer_tpu_torch.parallel.train import adam, init_train_state
from opencl_ray_tracer_tpu_torch.runtime import graph
from opencl_ray_tracer_tpu_torch.utils import tracing

torch.set_num_threads(2)

W, H = 128, 64
FRAME_SPANS = ("frame.pack", "frame.bin", "frame.gather", "frame.replay.host_read")


@pytest.fixture(autouse=True)
def clean():
    tracing.reset()
    yield
    tracing.reset()


def _inputs():
    scene = T.create_scene1(device="cpu")
    cam = T.pinhole_camera((W / 2.0, H / 2.0, 300.0), (W / 2.0, H / 2.0, -85.0),
                           fov_degrees=60.0, width=W, height=H, device="cpu")
    cfg = T.RenderConfig(width=W, height=H, shading="phong", shadows=True,
                         framebuffer_dtype="packed")
    return scene, cam, cfg


def _frame():
    """A CPU frame of scene 1 through a pinhole camera, on the tiled path
    (the kernels' plain twins). Its lists overflow the config's K caps
    once: the frame runs twice."""
    scene, cam, cfg = _inputs()
    return render(scene, cam, cfg, backend="pallas")


def _bins():
    """`bin_for_config`'s bins of `_frame`'s frame (re-binned once)."""
    scene, cam, cfg = _inputs()
    return fwd_tiled.bin_for_config(scene.pack(), cam, cfg)


def test_off_span_is_one_shared_null_and_records_nothing():
    assert tracing.span("frame.bin") is tracing.span("graph.replay")
    with tracing.span("frame.bin") as s:
        assert s is None
    _frame()
    snap = tracing.snapshot()
    assert snap["spans"] == {} and tracing.recent() == []
    assert tracing._totals == {} and tracing._open() == []
    # a CPU frame launches no kernel; device counters made earlier read 0;
    # it counts itself as an eager frame (this one runs again at a larger K:
    # two runs of the frame)
    counted = {k: v for k, v in snap["counters"].items() if v}
    assert counted == {"frame.eager": 1, "frame.rebinned": 1, "frame.runs": 2}


def test_recording_a_cpu_frame_nests_its_spans():
    with tracing.recording():
        out = _frame()
    assert out.shape == (H, W)
    spans = tracing.snapshot()["spans"]
    assert set(spans) == set(FRAME_SPANS)
    for name in FRAME_SPANS:  # the frame at the config's caps, then doubled
        assert spans[name]["count"] == 2, name
    for name, s in spans.items():
        assert 0.0 < s["self_s"] <= s["total_s"], name
        # the frame's spans hold no span
        assert s["self_s"] == s["total_s"], name
    # binning's own loop: frame.bin holds its host reads and nothing else
    tracing.reset()
    with tracing.recording():
        _bins()
    spans = tracing.snapshot()["spans"]
    assert set(spans) == {"frame.pack", "frame.bin", "frame.bin.host_read"}
    assert spans["frame.bin"]["count"] == 1
    assert spans["frame.bin.host_read"]["count"] == 2
    b, read = spans["frame.bin"], spans["frame.bin.host_read"]
    assert b["total_s"] - b["self_s"] == pytest.approx(read["total_s"], abs=1e-9)
    assert read["self_s"] == read["total_s"]
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
        _bins()
        parents = {name: parent for name, _, _, parent in tracing.recent()}
        assert parents == {"frame.pack": None, "frame.bin": None,
                           "frame.gather": None, "frame.replay.host_read": None,
                           "frame.bin.host_read": "frame.bin"}
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


def test_device_counters_are_one_block_read_and_zeroed_slot_by_slot():
    names = ("probe.block.rows", "probe.block.kept")
    assert tracing.device_counters(names, "cpu", make=False) is None
    block = tracing.device_counters(names, "cpu")
    assert block.dtype == torch.int64 and block.shape == (2,)
    assert tracing.device_counters(names, "cpu") is block
    assert tracing.device_counter(names[1], "cpu").data_ptr() == block[1:].data_ptr()
    block += torch.tensor([5, 2])  # what B1 adds, one add a block
    assert [tracing.counter(n) for n in names] == [5, 2]
    tracing.reset()
    assert block.tolist() == [0, 0]
    # a name made on its own first is no block's head: no slot is widened
    tracing.device_counter("probe.alone.rows", "cpu")
    with pytest.raises(ValueError, match="probe.alone.rows"):
        tracing.device_counters(("probe.alone.rows", "probe.alone.kept"), "cpu")


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


def test_mesh_all_reduce_is_a_span_and_counts_each_exchange():
    """`Mesh.all_reduce` runs inside the span `mesh.all_reduce`; a mesh with
    a group (one gloo rank here) counts each call as one exchange of the
    buffer's bytes, spans on or off, and a one-rank mesh without a group
    exchanges nothing and counts nothing."""
    import torch.distributed as dist

    from opencl_ray_tracer_tpu_torch.parallel import distributed
    from opencl_ray_tracer_tpu_torch.parallel.mesh import Mesh, make_mesh

    buf = torch.ones(5)
    with tracing.recording():
        Mesh((1,), ("image",)).all_reduce(buf)
    assert tracing.snapshot()["spans"]["mesh.all_reduce"]["count"] == 1
    assert tracing.counter("mesh.all_reduces") == 0
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{distributed.free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        with tracing.recording():
            mesh.all_reduce(buf)
        mesh.all_reduce(buf)
    finally:
        dist.destroy_process_group()
    assert torch.equal(buf, torch.ones(5))
    assert tracing.snapshot()["spans"]["mesh.all_reduce"]["count"] == 2
    assert tracing.counter("mesh.all_reduces") == 2
    assert tracing.counter("mesh.all_reduce_bytes") == 2 * 5 * 4


def test_an_app_trace_reads_its_frame_back_in_the_span_app_readback():
    """`MainState.run_trace` copies the frame to the host inside the span
    `app.readback` (recorded only while tracing is on) and counts each copy
    and its bytes (always); the host copy is the frame, and the buffer is
    kept from trace to trace."""
    from opencl_ray_tracer_tpu_torch import app

    cfg = T.RenderConfig(width=W, height=H, shading="legacy")
    sm = app.StateManager()
    st = app.MainState(sm, app.InputManager(), config=cfg, device="cpu")
    sm.add_state(st)
    sm.update(0.016)  # the startup trace, tracing off
    first = st.host_framebuffer
    assert "app.readback" not in tracing.snapshot()["spans"]
    with tracing.recording():
        for _ in range(2):
            sm.event_handler("r")
            sm.update(0.016)
    spans = tracing.snapshot()["spans"]
    assert spans["app.readback"]["count"] == 2
    assert spans["app.readback"]["self_s"] > 0
    assert tracing.counter("app.readbacks") == 3
    assert tracing.counter("app.readback_bytes") == 3 * H * W * 4 * 4
    assert st.host_framebuffer is first and st.host_framebuffer.device.type == "cpu"
    assert torch.equal(st.host_framebuffer, st.framebuffer)
