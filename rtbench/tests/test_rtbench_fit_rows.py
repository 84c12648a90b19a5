"""The row-sharded fit (`loops/fit_rows.py`) over four gloo ranks on the
CPU, each rank a process (`rank.py`): a correct run through `execute` with
the rank mesh's metrics, the control and the step without the all-reduce
failing the check, a killed rank ending the run with no result line and
no rank left, the guard's patience, and the new readers on hand-made
inputs. Rank 0 runs in
a subprocess of its own, as `run.py` would, since it makes a process
group."""

import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from rtbench.lib import files

SCENE = {"generator": "random_scene", "n_spheres": 12, "n_cubes": 4,
         "bounds": [127.0, 63.0], "layout_seed": 3,
         "lights": {"position": [[60.0, 30.0, 200.0]], "colour": [[1.0, 1.0, 1.0]],
                    "intensity": [1.0], "ambient": 0.1, "spec_strength": 0.5,
                    "shininess": 32.0}}
# scene 3's mix at 128 x 64 (16 rows a rank); fits of 4 steps, the loss read
# every 2, a traced stretch of one block
SMALL = {"config": {"width": 128, "height": 64, "scene": SCENE},
         "traffic": {"steps_per_fit": 4, "log_every": 2, "trace_units": 2,
                     "trace_align": 4, "warmup_seconds": 0.0}}
SEED = 2 ** 31 + 4099
# the exchange's buffer: the loss and every leaf's gradient, frozen leaves'
# included (12 spheres, 48 triangles, one light)
FLAT_BYTES = 4 * (1 + 12 * (3 + 1 + 4) + 48 * (9 + 4) + 10)
# what a rank other than 0 prints on standard error once it follows
FOLLOWS = re.compile(r"\(pid (\d+)\) follows rank 0")

RANK0 = r'''
import argparse, json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from rtbench.lib import files, guard
from rtbench.lib.main import Run, emit, execute
over = json.loads({over!r})
a = argparse.Namespace(workload="scene3_4k.fit4", seed={seed}, seconds={seconds},
                       trace={trace})
if {control}:
    run = Run(a, files.benchmark(), torch.device("cpu"), over)
    loop = files.load("loops", "fit_rows")
    loop.setup(run)
    print(json.dumps({{"low": loop.control(run), "limits": run.limits}}))
else:
    res, checks, run = execute(a, torch.device("cpu"), overrides=over)
    res["forbidden"] = guard.forbidden_loaded()
    emit(res, checks, run.notes)
'''


def _rank0(seconds, trace=0, control=False):
    code = RANK0.format(root=files.ROOT, over=json.dumps(SMALL), seed=SEED,
                        seconds=seconds, trace=trace, control=control)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(") ")[1][0] != "Z"
    except FileNotFoundError:
        return False


def test_four_gloo_ranks_give_a_correct_result_line():
    # a step takes about 1.5 s here: 10 s hold a multiple of trace_align
    # past the window's middle, where the traced stretch opens
    p = _rank0(10.0, trace=1)
    out, err = p.communicate(timeout=600)
    assert p.returncode == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True and res["forbidden"] == []
    assert res["device"]["count"] == 4
    m = res["metrics"]
    assert m["step.allreduce_kb"]["value"] == pytest.approx(FLAT_BYTES / 1024.0)
    # no device on the CPU: no NCCL kernel, no busy time to compare
    assert "step.allreduce_ms" not in m and "step.rank_skew_pct" not in m
    # every rank profiled the traced stretch, its profiler started before
    # the stretch opened (no device time on the CPU: 0 s, no NCCL kernel)
    assert "the ranks' profilers started before the traced stretch: True" in err
    assert "a traced step: [(0.0, None), (0.0, None), (0.0, None), (0.0, None)]" in err
    pids = [int(q) for q in FOLLOWS.findall(err)]
    assert len(pids) == 3 and not any(_alive(q) for q in pids)


def test_the_control_and_the_step_without_the_exchange_fail_the_check():
    p = _rank0(0.0, control=True)
    out, err = p.communicate(timeout=600)
    assert p.returncode == 0, err[-3000:]
    got = json.loads(out.strip().splitlines()[-1])
    low, lim = got["low"], got["limits"]
    assert set(low) == {"control", "half_rows", "no_allreduce"}
    for name in ("half_rows", "no_allreduce"):
        assert any(low[name][k] > lim[k] for k in ("loss_gap", "grad_gap")), low
    # without the exchange rank 0's loss is its rows' share of the frame's
    assert low["no_allreduce"]["loss_gap"] > 0.5


def test_a_killed_rank_ends_the_run_with_no_result_line():
    p = _rank0(300.0)
    pids, t0 = [], time.monotonic()
    try:
        while len(pids) < 3 and time.monotonic() - t0 < 300:
            line = p.stderr.readline()
            if not line:
                break
            pids += [int(q) for q in FOLLOWS.findall(line)]
        assert len(pids) == 3
        time.sleep(1.0)
        os.kill(pids[1], signal.SIGKILL)
        t1 = time.monotonic()
        out, err = p.communicate(timeout=60)
        # the guard polls its children every 0.2 s
        assert time.monotonic() - t1 < 30
    finally:
        if p.poll() is None:
            p.kill()
    # the guard ends rank 0, or on the CPU gloo's error may end it first;
    # either way rank 0 waits for the other ranks' exits before its own
    assert p.returncode != 0 and out.strip() == ""
    assert not any(_alive(q) for q in pids)


STALL = r'''
import subprocess, sys, time
sys.path.insert(0, {root!r})
from rtbench.lib.ranks import Guard
child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
print(child.pid, flush=True)
Guard([child], patience=1.0)
time.sleep(60)
'''


def test_the_guard_ends_every_rank_after_its_patience():
    p = subprocess.Popen([sys.executable, "-c", STALL.format(root=files.ROOT)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    child = int(p.stdout.readline())
    t0 = time.monotonic()
    out, err = p.communicate(timeout=60)
    assert p.returncode == 1 and time.monotonic() - t0 < 20
    assert "no progress for 1 s" in err
    time.sleep(0.5)
    assert not _alive(child)


class _Run:
    def __init__(self, trace=None, inputs=None):
        self.trace, self.inputs, self._memo = trace, inputs or {}, {}

    def memo(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]


RED = {"units": 10, "busy_s": 0.05, "window_s": 0.06,
       "by_name": {"ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)": 0.008,
                   "void (anonymous namespace)::soft_fwd_kernel<false, 1>(Params)": 0.03,
                   "Memcpy DtoH (Device -> Pinned)": 0.012}}


def test_allreduce_ms_reads_nccl_kernels_a_step():
    """The least of the ranks' NCCL time a step: the slowest rank's."""
    read = files.load("metrics", "step.allreduce_ms").read
    times = [(2.7e-3, 0.6e-3), (2.9e-3, 0.08e-3), (2.8e-3, 0.3e-3), (2.6e-3, 0.7e-3)]
    assert read(_Run(inputs={"rank_times": times})) == pytest.approx(0.08)
    assert read(_Run(inputs={"rank_times": times[:3] + [(2.6e-3, None)]})) is None
    assert read(_Run(inputs={"rank_times": times[:3] + [None]})) is None
    assert read(_Run()) is None


def test_allreduce_kb_reads_the_programs_counters():
    from opencl_ray_tracer_tpu_torch.utils import tracing

    read = files.load("metrics", "step.allreduce_kb").read
    tracing.reset()
    try:
        assert read(_Run()) is None  # a program that counts no exchange
        tracing.count("mesh.all_reduces", 3)
        tracing.count("mesh.all_reduce_bytes", 3 * 65644)
        assert read(_Run()) == pytest.approx(65644 / 1024.0)
    finally:
        tracing.reset()


def test_rank_skew_and_compute_s():
    """A rank's own and NCCL seconds a step (`rank_times`), and the skew of
    the own times across the ranks."""
    loop = files.load("loops", "fit_rows")
    own, nccl = loop.rank_times(RED)
    assert own == pytest.approx((0.05 - 0.008) / 10) and nccl == pytest.approx(0.008 / 10)
    plain = dict(RED, by_name={k: v for k, v in RED["by_name"].items() if "nccl" not in k})
    assert loop.rank_times(plain) == (pytest.approx(0.005), None)
    assert loop.rank_times(None) is None
    read = files.load("metrics", "step.rank_skew_pct").read
    times = lambda own: [None if o is None else (o, 1e-4) for o in own]  # noqa: E731
    assert read(_Run(inputs={"rank_times": times([1.0, 0.9, 0.8, 1.0])})) == pytest.approx(20.0)
    assert read(_Run(inputs={"rank_times": times([1.0, None, 0.8, 1.0])})) is None
    assert read(_Run(inputs={"rank_times": times([0.0] * 4)})) is None
    assert read(_Run()) is None


def test_reports_cross_the_steering_group_as_pairs():
    from rtbench.lib import ranks

    for value in [(0.0027, 0.0006), (0.0027, None), None]:
        assert ranks._report_value(ranks._report_tensor(value)) == value
