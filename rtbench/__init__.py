"""rtbench: the benchmark of opencl_ray_tracer_tpu_torch on NVIDIA cards.

`python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON line. Everything
that belongs to one configuration, traffic mix, cell or metric is a file of
its own, found by name: `configs/<config>.json`, `traffic/<mix>.json`
(whose "loop" names `loops/<loop>.py`), `limits/<cell>.json` and
`metrics/<metric>.py`. `reference/` is the plain reference the port is held
to, `roofline/` the operation and byte counts and the card's peaks.
"""
