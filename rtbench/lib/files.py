"""BENCHMARK.json and the files it names, found by name."""

from __future__ import annotations

import importlib.util
import json
import os

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(PKG, *parts)) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"rtbench: no workload {name!r} in BENCHMARK.json "
                     f"(have {[w['name'] for w in bench['workloads']]})")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(ROOT, c["file"])) as f:
                return json.load(f)
    raise SystemExit(f"rtbench: no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def limits(cell_name: str) -> dict:
    return _json("limits", f"{cell_name}.json")


def load(kind: str, name: str):
    """The module rtbench/<kind>/<name>.py (a name may hold dots)."""
    path = os.path.join(PKG, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"rtbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell_name: str, section: str) -> list:
    """The entries of `section` ("end_to_end" or "per_layer") this cell
    reports: those that list it under "workloads"; one that lists none,
    end to end in every cell, per layer in every cell that reports the
    end-to-end metric it moves."""
    e2e = {m["name"] for m in metrics_of_e2e(bench, cell_name)}
    if section == "end_to_end":
        return metrics_of_e2e(bench, cell_name)
    return [m for m in bench[section]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def metrics_of_e2e(bench: dict, cell_name: str) -> list:
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]
