#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on the card and print one JSON line:

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See rtbench/__init__.py and rtbench/lib/main.py."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# Libraries that would load JAX by themselves are kept from it.
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from rtbench.lib.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
