#!/usr/bin/env python3
"""One rank other than rank 0 of a cell whose traffic mix runs several
ranks (its "ranks" key): started by the cell's loop on rank 0
(`rtbench/lib/ranks.py`), never by hand, with the variables `torchrun`
sets. It makes the same run as rank 0 (`lib.main.Run` from the same
files and overrides), calls the loop's `follow`, and exits: 0 once rank 0
has told it to stop, 3 where it loaded JAX or the JAX package.

    python3 rtbench/rank.py --workload <cell> --seed <n> --device cuda|cpu
                            --overrides <json>"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# Libraries that would load JAX by themselves are kept from it.
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rtbench/rank.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--overrides", default="{}")
    args = ap.parse_args(argv)
    from rtbench.lib.ranks import Follower

    follower = Follower()  # the watchdog first: rank 0 may already be gone
    import torch

    from rtbench.lib import files, guard
    from rtbench.lib.main import Run

    dev = (torch.device("cuda", int(os.environ["LOCAL_RANK"])) if args.device == "cuda"
           else torch.device("cpu"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # nothing of this rank on another card
    ns = argparse.Namespace(workload=args.workload, seed=args.seed, seconds=0.0, trace=0)
    run = Run(ns, files.benchmark(), dev, json.loads(args.overrides))
    files.load("loops", run.traffic["loop"]).follow(run, follower)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"rtbench: rank {os.environ['RANK']} loaded {', '.join(bad)}",
              file=sys.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
    # no teardown: the process group's end is rank 0's, and a collective
    # left in a destructor would wait on ranks that are gone
    os._exit(3 if bad else 0)


if __name__ == "__main__":
    sys.exit(main())
