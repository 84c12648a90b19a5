"""Old and new kept apart: no JAX, no JAX package (by whole top-level name),
the reference and the counts import nothing of the port, nothing reads the
old records; and no result without a card."""

import ast
import os
import subprocess
import sys

from rtbench.lib import files, guard


def test_forbidden_names_are_compared_whole():
    mods = ["opencl_ray_tracer_tpu_torch", "opencl_ray_tracer_tpu_torch.kernels",
            "jaxtyping", "flaxen", "numpy"]
    assert guard.forbidden_loaded(mods) == []
    assert guard.forbidden_loaded(mods + ["opencl_ray_tracer_tpu.config"]) == [
        "opencl_ray_tracer_tpu"]
    assert guard.forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(*parts):
    for dirpath, _, names in os.walk(os.path.join(files.PKG, *parts)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def test_reference_and_counts_import_nothing_of_the_port():
    for path in list(_sources("reference")) + list(_sources("roofline")):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("opencl_ray_tracer_tpu_torch",) + guard.FORBIDDEN, (path, mod)


def test_nothing_imports_jax_or_reads_the_old_records():
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        for mod in _imports(path):
            assert mod.split(".")[0] not in guard.FORBIDDEN, (path, mod)
        text = open(path).read()
        for old in ("BENCH_r0", "MULTICHIP_r0", "bench.py\"", "'bench.py'"):
            assert old not in text, (path, old)


def test_no_card_no_result(tmp_path):
    """Without a visible card the run exits non-zero and prints nothing on
    standard output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(files.PKG, "run.py"), "--workload",
                        "rt10_1080.fly", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "card" in p.stderr


def test_a_port_run_loads_no_jax(small):
    code = (
        "import argparse, sys, torch\n"
        f"sys.path.insert(0, {files.ROOT!r})\n"
        "from rtbench.lib.main import execute\nfrom rtbench.lib import guard\n"
        f"over = {small['rt10_1080.fly']!r}\n"
        "a = argparse.Namespace(workload='rt10_1080.fly', seed=3, seconds=0.3, trace=0)\n"
        "execute(a, torch.device('cpu'), overrides=over)\n"
        "print(guard.forbidden_loaded())\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
