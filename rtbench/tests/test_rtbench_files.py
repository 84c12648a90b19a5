"""BENCHMARK.json and the files it names: each cell's configuration,
traffic mix, loop and limits, and each metric's reader, found by name; a
new cell, mix and metric added as files alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from rtbench.lib import files

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_in_benchmark_has_its_files():
    b = files.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("rtbench/") and os.path.isfile(
            os.path.join(files.ROOT, c["file"]))
        assert json.load(open(os.path.join(files.ROOT, c["file"])))["name"] == c["name"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and len(w["why"]) <= 200
        loop = files.traffic(w["traffic"])["loop"]
        mod = files.load("loops", loop)
        for fn in ("setup", "release", "check", "control"):
            assert callable(getattr(mod, fn))
        assert files.limits(w["name"])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert callable(files.load("metrics", m["name"]).read)
    for w in b["workloads"]:
        e2e = files.metrics_of(b, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert files.metrics_of(b, w["name"], "per_layer")
    for m in b["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in
                                  files.metrics_of(b, cell, "end_to_end")}


def test_metrics_of_follows_the_workloads_key():
    b = {"end_to_end": [{"name": "a", "workloads": ["x"]}, {"name": "setup_s"}],
         "per_layer": [{"name": "p", "moves": "a"},
                       {"name": "q", "moves": "setup_s", "workloads": ["y"]}]}
    assert [m["name"] for m in files.metrics_of(b, "x", "end_to_end")] == ["a", "setup_s"]
    assert [m["name"] for m in files.metrics_of(b, "y", "end_to_end")] == ["setup_s"]
    assert [m["name"] for m in files.metrics_of(b, "x", "per_layer")] == ["p"]
    assert [m["name"] for m in files.metrics_of(b, "y", "per_layer")] == ["q"]


ADDED = r'''
import argparse, json, sys
sys.path.insert(0, sys.argv[1])
sys.path.append(sys.argv[2])
import torch
from rtbench.lib.main import execute
args = argparse.Namespace(workload="tiny.fly_fast", seed=7, seconds=0.5, trace=0)
res, checks, run = execute(args, torch.device("cpu"))
print(json.dumps(res))
'''


def test_a_new_cell_mix_and_metric_are_files_alone(tmp_path, small):
    """Copy the benchmark, add a configuration, a traffic mix, a cell's limits
    and a per-layer metric as new files plus BENCHMARK.json entries, and run
    the new cell: no file that was there is edited."""
    shutil.copytree(files.PKG, tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = files.benchmark()
    before = {p: open(p, "rb").read() for p in map(str, (tmp_path / "rtbench").rglob("*"))
              if os.path.isfile(p)}
    cfg = json.load(open(os.path.join(files.PKG, "configs", "rt10_1080.json")))
    cfg.update(small["rt10_1080.fly"]["config"], name="tiny")
    (tmp_path / "rtbench/configs/tiny.json").write_text(json.dumps(cfg))
    mix = json.load(open(os.path.join(files.PKG, "traffic", "fly.json")))
    mix.update(small["rt10_1080.fly"]["traffic"])
    mix["orbit"] = dict(mix["orbit"], fov_degrees=45.0)
    (tmp_path / "rtbench/traffic/fly_fast.json").write_text(json.dumps(mix))
    (tmp_path / "rtbench/limits/tiny.fly_fast.json").write_text(
        json.dumps({"frame_mismatch_share": 0.5}))
    (tmp_path / "rtbench/metrics/frames_done.py").write_text(
        "def read(run):\n    return float(run.window['units'])\n")
    b["configs"].append({"name": "tiny", "source": "test", "file": "rtbench/configs/tiny.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny.fly_fast", "config": "tiny",
                           "traffic": "fly_fast", "chips": 1, "why": "test"})
    for m in b["end_to_end"]:
        if "rt10_1080.fly" in m.get("workloads", []):
            m["workloads"].append("tiny.fly_fast")
    b["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                            "bound": 0.25, "source": "host_clock",
                            "workloads": ["tiny.fly_fast"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    p = subprocess.run([sys.executable, "-c", ADDED, str(tmp_path), files.ROOT],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert {"frame_p95_ms", "setup_s", "frames_done"} <= set(res["metrics"])
    for path, data in before.items():
        assert open(path, "rb").read() == data, path


@pytest.mark.parametrize("kind", ["loops", "metrics"])
def test_a_name_with_dots_loads_from_its_file(kind):
    name = {"loops": "frames", "metrics": "frame.device_ops"}[kind]
    assert files.load(kind, name).__file__.endswith(f"{name}.py")
