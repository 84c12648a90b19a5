#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's own
size: for each seed, what the check compares for the program (the loop's
set-up, then the check, with no measured window), for the control (the
reference in bfloat16 in the program's place) and for the faults the loop
plants in the reference.

    python3 rtbench/tools/control.py --workload <cell> --seeds 11 12 13

One JSON line a seed on standard output. The benchmark's own runs never
run this."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import torch

    from rtbench.lib import files, guard
    from rtbench.lib.main import Run

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = files.benchmark()
    guard.require_cards(int(files.cell(bench, args.workload)["chips"]))
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        ns = argparse.Namespace(workload=args.workload, seed=seed, seconds=0.0,
                                trace=0)
        run = Run(ns, bench, dev)
        loop = files.load("loops", run.traffic["loop"])
        t0 = time.perf_counter()
        unit = loop.setup(run)
        if run.traffic["loop"] == "frames":
            for i in range(run.traffic["orbit"]["frames_per_turn"]):
                unit(i)
        run.sync()
        t1 = time.perf_counter()
        sound = {n: v for n, v, _ in loop.check(run)}
        t2 = time.perf_counter()
        low = loop.control(run)
        t3 = time.perf_counter()
        print(json.dumps({"workload": args.workload, "seed": seed, "sound": sound,
                          "control": low, "setup_s": t1 - t0, "check_s": t2 - t1,
                          "control_s": t3 - t2, "notes": run.notes}), flush=True)
        del run, unit
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
