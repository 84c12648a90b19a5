"""The benchmark's cell `scene1_640.app`: the reference app at its default
(scene 1, 640 x 480, the legacy ortho camera, depth fog, the int
framebuffer) re-run through the port's `app.MainState`, the frame read back
to the host inside the timed trace.

On the CPU at the cell's own size (the plain twins take ~0.2 s a frame):
the cell's run through `rtbench.lib.main.execute`, held by its own check
and limits against the benchmark's plain reference (`rtbench/reference/`);
the host copy of each checked frame against the frame the app rendered,
word for word; the frame's faults (the depth fog at a wrong constant, or
left out) and the reference in bfloat16 read above the limit; the loop's
scene 1, built from the configuration's numbers, against the port's
library scene; and the reader `frame.readback_ms`."""

import argparse
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import opencl_ray_tracer_tpu_torch as T  # noqa: E402
from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled  # noqa: E402
from opencl_ray_tracer_tpu_torch.utils import tracing  # noqa: E402
from rtbench.lib import files  # noqa: E402
from rtbench.lib.main import Run, execute  # noqa: E402

torch.set_num_threads(2)

CELL = "scene1_640.app"
SEED = 2 ** 31 + 4099
CPU = torch.device("cpu")
SMALL_TRAFFIC = {"warmup_seconds": 0.0, "check_frames": 3, "trace_units": 3}
OVER = {"traffic": SMALL_TRAFFIC}
LIMITS = files.limits(CELL)

app = files.load("loops", "app")


@pytest.fixture
def clean():
    tracing.reset()
    yield
    tracing.reset()


def _args(trace, seconds):
    return argparse.Namespace(workload=CELL, seed=SEED, seconds=seconds, trace=trace)


def _traced_seconds():
    """A window in whose second half a frame surely ends (see
    `tests/test_torch_hard_cells.py`): six times a frame timed now, at
    least 3 s."""
    _, _, run = execute(_args(0, 0.0), CPU, overrides=OVER)
    return max(3.0, 6.0 * max(run.window["latencies_s"]))


@pytest.mark.parametrize("trace", [0, 1])
def test_the_app_cell_runs_and_reports(clean, trace):
    seconds = _traced_seconds() if trace else 0.6
    res, checks, run = execute(_args(trace, seconds), CPU, overrides=OVER)
    assert res["correct"] is True, checks
    assert [c[0] for c in checks] == ["frame_mismatch_share", "readback_mismatch_words"]
    assert res["checks"]["readback_mismatch_words"]["value"] == 0
    assert res["attempted"] > 0
    got = set(res["metrics"])
    if not trace:
        assert got == {"frame_p95_ms", "setup_s"}
        return
    assert {"frame.mean_ms", "frame.device_ops", "frame.idle_pct",
            "frame.readback_ms"} <= got
    assert res["metrics"]["frame.readback_ms"]["value"] > 0
    assert res["metrics"]["frame.runs_per_frame"]["value"] == 1.0  # no overflow
    assert res["metrics"]["frame.replay_pct"]["value"] == 0.0  # CPU frames
    # a CPU trace holds no device operation, so no B1 to read
    assert "frame.b1_roofline" not in got
    # one readback a trace, of the whole int framebuffer
    c = tracing.snapshot()["counters"]
    assert c["app.readback_bytes"] == c["app.readbacks"] * 640 * 480 * 4 * 4


def test_the_host_frame_is_the_apps_frame_word_for_word(clean):
    _, _, run = execute(_args(0, 0.6), CPU, overrides=OVER)
    kept = run.inputs["kept"]
    assert kept and 0 in kept
    for card, host in kept.values():
        assert host is not None and host.dtype == torch.int32
        assert host.shape == (480, 640, 4)
        assert torch.equal(host, card)
        assert int((host[..., :3] != 0).any(-1).sum()) > 10_000  # scene 1 is there


@pytest.mark.parametrize("fog", [200.0, float("inf")])
def test_a_wrong_depth_fog_is_not_correct(clean, monkeypatch, fog):
    """The fog at a wrong constant, or left out (each hit at full colour)."""
    monkeypatch.setattr(fwd_tiled, "LEGACY_FOG_MAX", fog)
    res, checks, _ = execute(_args(0, 0.3), CPU, overrides=OVER)
    assert res["correct"] is False and res["failed"] == 1, checks
    assert res["checks"]["frame_mismatch_share"]["value"] > LIMITS["frame_mismatch_share"]


def test_the_app_control_is_not_correct(clean):
    run = Run(_args(0, 0.3), files.benchmark(), CPU, OVER)
    app.setup(run)
    app.release(run)
    low = app.control(run)
    assert low["frame_mismatch_share"] > LIMITS["frame_mismatch_share"]


def test_the_loops_scene_is_the_port_library_scene_1():
    spec = files.config(files.benchmark(), "scene1_640")["scene"]
    arrays = app.scene_arrays(spec, CPU)
    lib = T.create_scene1(device="cpu")
    for k in ("sphere_origin", "sphere_radius", "sphere_colour", "tri_colour"):
        assert torch.equal(arrays[k], getattr(lib, k)), k
    torch.testing.assert_close(arrays["tri_verts"], lib.tri_verts, rtol=0, atol=1e-4)
    assert arrays["lights.position"].shape == (0, 3)


def _readback_ms(spans, units=40):
    class _Run:
        trace = {"units": units} if units else None

        def memo(self, key, make):
            return {"spans": spans, "counters": {}}

    return files.load("metrics", "frame.readback_ms").read(_Run())


def test_readback_ms_reads_the_span_over_the_traced_frames():
    span = {"app.readback": {"count": 40, "total_s": 0.012, "self_s": 0.010}}
    assert _readback_ms(span) == pytest.approx(0.25)
    # an app that keeps the frame on the card, or no trace
    assert _readback_ms({}) is None
    assert _readback_ms(span, units=0) is None
