"""One run of one cell: set-up, the measured window, the check of what the
window produced against the reference, the metrics, and the result line.

A cell of BENCHMARK.json names a configuration (`configs/<name>.json`) and
a traffic mix (`traffic/<name>.json`); the mix names its loop
(`loops/<loop>.py`), which makes the inputs from the seed (`setup`), runs a
unit of work (`unit`), frees the program's state after the window
(`release`) and compares what the window produced with the reference
(`check`, against `limits/<cell>.json`). Every metric is a reader
`metrics/<name>.py` with `read(run)`: the number, or None where it has
nothing to read."""

from __future__ import annotations

import argparse
import json
import sys
import time

from rtbench.lib import files, guard
from rtbench.lib.spans import Spans
from rtbench.lib.window import drive


class Run:
    """What a run knows: its arguments, the cell's files, the device, the
    loop's inputs and state, the window's counts and, with a trace, the
    reduced trace; `memo` keeps what several readers compute once."""

    def __init__(self, args, bench, device, overrides=None):
        over = overrides or {}
        self.args = args
        self.seed = args.seed
        self.bench = bench
        self.cell = files.cell(bench, args.workload)
        self.config = {**files.config(bench, self.cell["config"]),
                       **over.get("config", {})}
        self.traffic = {**files.traffic(self.cell["traffic"]),
                        **over.get("traffic", {})}
        self.limits = {**files.limits(self.cell["name"]), **over.get("limits", {})}
        self.device = device
        self.spans = Spans()
        self.inputs = {}
        self.window = {}
        self.trace = None
        self.setup_s = None
        self.memory_peak_bytes = None
        self.notes = []
        self._memo = {}

    def sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def memo(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def note(self, text: str):
        """A line for standard error, printed before the checks."""
        self.notes.append(text)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="rtbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args, device, bench=None, overrides=None) -> tuple:
    """(result dict, checks, run) of one run on `device`, with no look for a
    card: what `main` prints. Tests drive it on the CPU at small sizes, with
    `overrides` ({"config": {...}, "traffic": {...}, "limits": {...}})
    replacing top-level keys of the cell's files."""
    import torch

    bench = bench or files.benchmark()
    run = Run(args, bench, device, overrides)
    loop = files.load("loops", run.traffic["loop"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    unit = loop.setup(run)
    run.sync()
    run.setup_s = time.perf_counter() - t0
    run.window = drive(unit, args.seconds, run.sync, run.spans,
                       trace_units=run.traffic["trace_units"] if args.trace else 0,
                       align=run.traffic.get("trace_align", 1))
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if "trace" in run.window:
        from rtbench.lib import trace

        prof, first, n = run.window.pop("trace")
        run.trace = trace.from_profiler(prof, n, "window")
        t = run.trace
        run.note(f"traced stretch: {n} units from unit {first}, {t['window_s']:.6f} s, "
                 f"busy {t['busy_s']:.6f} s, {t['n_ops']} device operations; "
                 f"a unit outside it {run.window['untraced_unit_s']:.6e} s")
    loop.release(run)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    checks = loop.check(run)
    run.note(f"set-up {run.setup_s:.3f} s, window {run.window['wall_s']:.3f} s "
             f"for {run.window['units']} units, check "
             f"{time.perf_counter() - t1:.3f} s, memory peak "
             f"{run.memory_peak_bytes} B")
    over = sum(not v <= lim for _, v, lim in checks)
    correct = not over
    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in files.metrics_of(bench, run.cell["name"], section):
        value = files.load("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": run.window["units"],
              "failed": over, "metrics": metrics}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": int(run.cell["chips"]),
           "memory_peak_bytes": run.memory_peak_bytes or 0}
    if run.trace is not None:
        from rtbench.lib import trace

        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = trace.breakdown(run.trace)
    result["device"] = dev
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result, checks, run


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    bench = files.benchmark()
    chips = int(files.cell(bench, args.workload)["chips"])
    guard.require_cards(chips)
    import torch

    result, checks, run = execute(args, torch.device("cuda", 0), bench)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"rtbench: modules of JAX or of the JAX package were loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    emit(result, checks, run.notes)
    return 0


def emit(result: dict, checks, notes, out=None, err=None) -> None:
    """The notes, then each number compared beside its limit as the last
    lines of standard error; the result as the last line of standard
    output, its "checks" key last."""
    out, err = out or sys.stdout, err or sys.stderr
    for line in notes:
        print(f"# {line}", file=err)
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r}", file=err)
    err.flush()
    result = {k: v for k, v in result.items() if k != "checks"} | {
        "checks": result["checks"]}
    print(json.dumps(result), file=out, flush=True)
