"""The result line: its keys, the checks last on both streams, and with
--trace 1 the per-layer metrics, busy and window seconds and the
breakdown."""

import argparse
import io
import json

import torch

from rtbench.lib.main import emit, execute


def _args(workload, trace, seconds=0.6):
    return argparse.Namespace(workload=workload, seed=2 ** 31 + 77, seconds=seconds,
                              trace=trace)


def test_last_line_and_checks_last(small):
    res, checks, run = execute(_args("rt10_1080.fly", 0), torch.device("cpu"),
                               overrides=small["rt10_1080.fly"])
    out, err = io.StringIO(), io.StringIO()
    emit(res, checks, run.notes, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"frame_p95_ms", "setup_s"}
    assert line["metrics"]["frame_p95_ms"]["unit"] == "ms"
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    last = err.getvalue().strip().splitlines()[-1]
    assert last.startswith("check frame_mismatch_share ") and " limit " in last


def test_fit_cell_metrics(small):
    res, checks, _ = execute(_args("rt10_1080.fit", 0, 1.0), torch.device("cpu"),
                             overrides=small["rt10_1080.fit"])
    assert set(res["metrics"]) == {"step_ms", "setup_s"}
    assert [c[0] for c in checks] == ["loss_gap", "grad_gap", "change_gap"]
    assert res["correct"] is True


def test_traced_run_reports_the_per_layer_metrics(small):
    res, _, run = execute(_args("rt10_1080.fly", 1), torch.device("cpu"),
                        overrides=small["rt10_1080.fly"])
    # on the CPU the trace holds no device operation: the readers of device
    # time return nothing, the counts read zero
    assert "frame.b1_roofline" not in res["metrics"]
    assert res["metrics"]["frame.device_ops"]["value"] == 0.0
    # the mean frame leaves out the traced stretch
    w = run.window
    assert res["metrics"]["frame.mean_ms"]["value"] == 1e3 * w["untraced_unit_s"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
