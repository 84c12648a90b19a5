"""The port's bench entry without a card: the aggregation policy, the
argument parsing and row plan, and that a run without a card fails instead
of timing the CPU."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from opencl_ray_tracer_tpu_torch import bench, bench_util, cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("samples,want", [
    ([3.0], (3.0, 3.0, 3.0)),
    ([5.0, 1.0, 3.0], (3.0, 1.0, 5.0)),
    ([4.0, 1.0, 2.0, 3.0], (2.5, 1.0, 4.0)),   # even: the true median
    (iter([2.0, 1.0]), (1.5, 1.0, 2.0)),       # any iterable
])
def test_median_spread(samples, want):
    assert bench_util.median_spread(samples) == want


def test_median_spread_raises_on_empty():
    with pytest.raises(ValueError, match="at least one"):
        bench_util.median_spread([])


def test_parse_args_defaults_and_flags():
    a = bench.parse_args([])
    assert (a.width, a.height, a.scene, a.shading) == (1920, 1080, None, "phong")
    assert not a.skip_context and not a.no_shadows and a.cull_k is None
    assert not a.skip_scaling and a.scaling_worker is None
    assert a.scaling_size == bench.SCALE_SIZE == 256
    a = bench.parse_args(["--scene", "3", "--width", "640", "--height", "480",
                          "--shading", "legacy", "--no-shadows", "--cull-k", "96",
                          "--skip-context", "--skip-scaling", "--scaling-worker",
                          "4", "--scaling-size", "64"])
    assert (a.scene, a.width, a.height, a.shading) == (3, 640, 480, "legacy")
    assert a.no_shadows and a.cull_k == 96 and a.skip_context
    assert a.skip_scaling and (a.scaling_worker, a.scaling_size) == (4, 64)
    with pytest.raises(SystemExit):
        bench.parse_args(["--scene", "7"])
    with pytest.raises(SystemExit):
        bench.parse_args(["--shading", "toon"])
    assert (bench.W4K, bench.H4K) == (3840, 2160)


@pytest.mark.parametrize("argv,want", [
    ([], [bench.HEADLINE, bench.DYNAMIC, bench.FWD_BWD, bench.TILED_LEGACY,
          bench.TILED_PINHOLE, bench.BRUTE_LEGACY, bench.STRESS,
          bench.SOFT_50_4, bench.STRESS_SOFT, bench.FOUR_K,
          bench.PINHOLE_PHONG, bench.PINHOLE_SOFT, bench.TRAIN]),
    (["--skip-context"], [bench.HEADLINE, bench.DYNAMIC, bench.FWD_BWD,
                          bench.TRAIN]),
    (["--skip-context", "--width", "640", "--height", "480"],
     [bench.HEADLINE, bench.DYNAMIC, bench.FWD_BWD, bench.TRAIN]),
    (["--scene", "2", "--width", "320", "--height", "200", "--shading", "lambert"],
     ["scene2 lambert 320x200"]),
])
def test_row_plan(argv, want):
    plan = bench.row_plan(bench.parse_args(argv))
    assert plan == want and len(set(plan)) == len(plan)


def test_timing_needs_a_card():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_util.call_times_ms(lambda: None, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_util.back_to_back_ms(lambda: None, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_util.device_ms(lambda: None, 1)


def test_bench_and_cli_raise_without_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--skip-context"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench", "--scene", "1"])


@pytest.mark.parametrize("backend", ["xla", "reference", "pallas"])
def test_cli_render_parses_every_backend_and_needs_a_card(backend):
    """`cli render --backend xla` parses like the other backends; render
    then refuses to run without a card, as before."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["render", "--scene", "1", "--backend", backend,
                  "--width", "64", "--height", "48"])


def test_cli_render_rejects_an_unknown_backend():
    with pytest.raises(SystemExit):
        cli.main(["render", "--backend", "opencl"])


def test_bench_module_exits_nonzero_without_card():
    proc = subprocess.run(
        [sys.executable, "-m", "opencl_ray_tracer_tpu_torch.bench",
         "--skip-context"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""  # no JSON line


@pytest.mark.parametrize("n", [1, 2])
def test_scaling_worker_prints_one_json_line(n):
    """`--scaling-worker N`: the sharded train step over N gloo CPU ranks
    (asked for explicitly: no card needed) on a tiny frame, one JSON line.
    One thread a process: the test shares the host with other workers."""
    proc = subprocess.run(
        [sys.executable, "-m", "opencl_ray_tracer_tpu_torch.bench",
         "--scaling-worker", str(n), "--scaling-size", "64"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["n"] == n and row["size"] == 64
    assert 0 < row["us_min"] <= row["us_per_step"] <= row["us_max"]
    assert row["loss"] > 0  # the frame holds part of scene 1


def _host_times(fn, n=50, warmup=3):
    """Stands in for call_times_ms on the CPU (the bench times on the card
    only): one call on the host's clock, whatever n asks."""
    t0 = time.perf_counter()
    fn()
    return [(time.perf_counter() - t0) * 1e3]


def test_mesh_rows_keys(monkeypatch):
    """The overhead row through the plain twins at a tiny size gives
    shard_map_overhead; --skip-scaling leaves the scaling keys out; with a
    scaling row they carry the JAX bench's names."""
    from opencl_ray_tracer_tpu_torch import RenderConfig, legacy_ortho_camera, random_scene

    monkeypatch.setattr(bench, "call_times_ms", _host_times)
    cpu = torch.device("cpu")
    scene = random_scene(4, 1, seed=0, bounds=(120.0, 56.0), device=cpu)
    cfg = RenderConfig(width=128, height=64, shading="phong", shadows=True,
                       framebuffer_dtype="packed")
    keys = bench.bench_mesh_rows(bench.parse_args(["--skip-scaling"]), scene, cfg,
                                 legacy_ortho_camera(device=cpu))
    assert set(keys) == {"shard_map_overhead", "sharded_fwd_ms", "unsharded_fwd_ms"}
    assert keys["sharded_fwd_ms"] > 0 and keys["unsharded_fwd_ms"] > 0
    assert keys["shard_map_overhead"] == pytest.approx(
        keys["sharded_fwd_ms"] / keys["unsharded_fwd_ms"] - 1.0)
    row = lambda us, lo, hi: {"us_per_step": us, "us_min": lo, "us_max": hi}  # noqa: E731
    keys = bench.mesh_keys(2.0, 1.0, {1: row(100.0, 90.0, 110.0),
                                      8: row(125.0, 120.0, 150.0)})
    assert keys["shard_map_overhead"] == 1.0
    assert keys["sharding_eff_8dev_fixed_work"] == pytest.approx(0.8)
    assert keys["sharding_eff_range"] == pytest.approx([0.6, 110.0 / 120.0])
    assert keys["sharding_eff_semantics"] == "cpu-mesh-structure-check"
