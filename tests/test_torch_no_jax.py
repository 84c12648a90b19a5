"""Guards that run everywhere: the port imports no JAX, a CUDA-device call
without a card raises instead of quietly running on the CPU, the kernel
wrapper only runs its plain twin for CPU tensors, and chip_smoke.py refuses
to pass without a card or without the repository beside it."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
from opencl_ray_tracer_tpu_torch.utils import tracing

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, pkgutil, sys
import opencl_ray_tracer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "opencl_ray_tracer_tpu"))
assert not bad, bad
for new in ("entry", "runtime.graph"):  # the compiled path's modules
    assert f"opencl_ray_tracer_tpu_torch.{new}" in names, new
# the last compiled forms, in modules that import no JAX either
from opencl_ray_tracer_tpu_torch.models.xla_backend import render_xla_jit
from opencl_ray_tracer_tpu_torch.parallel import render_sharded_jit
print(len(names))
"""

CUDA_CALLS = """
import runpy
import torch
import opencl_ray_tracer_tpu_torch as T
import opencl_ray_tracer_tpu_torch.cli
from opencl_ray_tracer_tpu_torch import app
assert not torch.cuda.is_available()
calls = (
    lambda: T.create_scene1(device="cuda"),
    lambda: T.legacy_ortho_camera(device="cuda"),
    lambda: T.Lights.default("cuda"),
    lambda: T.get_renderer("soft", width=128, height=64).render(
        T.create_scene1(device="cuda")),
    lambda: T.cli.main(["fit", "--steps", "2"]),
    lambda: __import__("opencl_ray_tracer_tpu_torch.entry").entry.entry(),
    lambda: T.cli.main(["bench", "--skip-context"]),
    lambda: app.MainState(app.StateManager(), app.InputManager()),
    lambda: T.cli.main(["compare"]),
    lambda: T.cli.main(["app", "--keys", "r,q"]),
    lambda: runpy.run_path("examples/torch_flythrough_demo.py", run_name="__main__"),
    lambda: runpy.run_path("examples/torch_inverse_rendering_demo.py",
                           run_name="__main__"),
)
for call in calls:
    try:
        call()
    except (RuntimeError, AssertionError):
        continue
    raise SystemExit("a cuda-device call returned without a card")
print("raised")
"""


def _run(code_or_args, cwd=REPO, **env):
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else code_or_args)
    return subprocess.run(
        args, cwd=cwd, env={**os.environ, **env}, capture_output=True,
        text=True, timeout=300,
    )


def test_port_imports_no_jax():
    proc = _run(IMPORT_ALL)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 53  # every ported module


def test_cuda_device_without_card_raises():
    proc = _run(CUDA_CALLS, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("raised")


def test_kernel_wrapper_device_policy():
    """CPU tensors take the plain twin (no launch counted); any device that
    is neither CPU nor CUDA is refused."""
    from opencl_ray_tracer_tpu_torch import (
        RenderConfig,
        create_scene1,
        legacy_ortho_camera,
    )

    cpu = torch.device("cpu")
    cfg = RenderConfig(width=128, height=64, shading="phong", shadows=True,
                       framebuffer_dtype="packed")
    packed = create_scene1(device=cpu).pack()
    bins = fwd_tiled.bin_for_config(packed, legacy_ortho_camera(device=cpu), cfg)
    args, kw = fwd_tiled.kernel_inputs(
        packed, legacy_ortho_camera(device=cpu), bins, height=64, width=128,
        shading="phong", shadows=True, out_format="packed")
    before = tracing.counter("launch.B1")
    out = fwd_tiled.tiled_kernel(*args, **kw)
    assert out.shape == (64, 128) and out.dtype == torch.int32
    assert tracing.counter("launch.B1") == before
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fwd_tiled.tiled_kernel(*meta, **kw)

    # the soft wrappers (B4, B5): the same policy
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled

    scfg = RenderConfig(width=128, height=64, shading="phong", shadows=True,
                        soft=True, framebuffer_dtype="float")
    params, taus, tables, counts, kc = soft_tiled.soft_kernel_inputs(
        packed, legacy_ortho_camera(device=cpu), scfg)
    tables = tuple(t.detach() for t in tables)
    before = (tracing.counter("launch.B4"), tracing.counter("launch.B5"))
    img = soft_tiled.soft_tiled_fwd(params.detach(), taus, tables, counts, cfg=kc)
    assert img.shape == (64, 128, 4) and img.dtype == torch.float32
    grads = soft_tiled.soft_tiled_bwd(params.detach(), taus, tables, counts,
                                      torch.ones_like(img), cfg=kc)
    assert [tuple(g.shape) for g in grads] == [
        tuple(t.shape) for t in (params, taus) + tables]
    assert (tracing.counter("launch.B4"), tracing.counter("launch.B5")) == before
    to_meta = lambda ts: tuple(t.to("meta") for t in ts)  # noqa: E731
    with pytest.raises(ValueError, match="cuda or cpu"):
        soft_tiled.soft_tiled_fwd(params.to("meta"), taus.to("meta"),
                                  to_meta(tables), counts.to("meta"), cfg=kc)
    with pytest.raises(ValueError, match="cuda or cpu"):
        soft_tiled.soft_tiled_bwd(params.to("meta"), taus.to("meta"),
                                  to_meta(tables), counts.to("meta"),
                                  img.to("meta"), cfg=kc)


def test_brute_wrappers_device_policy():
    """The brute wrappers (B3, B6, B7): CPU tensors take the plain twin (no
    launch counted); a device that is neither CPU nor CUDA is refused."""
    from opencl_ray_tracer_tpu_torch import (
        RenderConfig,
        create_scene1,
        legacy_ortho_camera,
    )
    from opencl_ray_tracer_tpu_torch.kernels import fwd, soft

    cpu = torch.device("cpu")
    packed = create_scene1(device=cpu).pack()
    cam = legacy_ortho_camera(device=cpu)
    cfg = RenderConfig(width=64, height=32, shading="phong", shadows=True,
                       framebuffer_dtype="float")
    args, kw = fwd.brute_kernel_inputs(packed, cam, cfg)
    before = tracing.counter("launch.B3")
    out = fwd.brute_kernel(*args, **kw)
    assert out.shape == (32, 64, 4) and out.dtype == torch.float32
    assert tracing.counter("launch.B3") == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        fwd.brute_kernel(*(a.to("meta") for a in args), **kw)
    with pytest.raises(ValueError, match="shading"):
        fwd.brute_kernel(*args, **{**kw, "shading": "toon"})

    inputs = [soft._camera_params(cam, packed.lights), torch.tensor([1.0, 0.5])]
    inputs += list(soft._prep_soft_arrays(packed))
    skw = dict(height=32, width=64,
               cfg=soft._static_cfg(packed, "phong", True, False))
    before = (tracing.counter("launch.B6"), tracing.counter("launch.B7"))
    img = soft.soft_brute_fwd(*inputs, **skw)
    assert img.shape == (32, 64, 4) and img.dtype == torch.float32
    grads = soft.soft_brute_bwd(*inputs, torch.ones_like(img), **skw)
    assert [tuple(g.shape) for g in grads] == [tuple(t.shape) for t in inputs]
    assert (tracing.counter("launch.B6"), tracing.counter("launch.B7")) == before
    meta = [t.to("meta") for t in inputs]
    with pytest.raises(ValueError, match="cuda or cpu"):
        soft.soft_brute_fwd(*meta, **skw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        soft.soft_brute_bwd(*meta, img.to("meta"), **skw)


def test_chip_smoke_fails_without_card():
    proc = _run([sys.executable, "chip_smoke.py"], CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run([sys.executable, "chip_smoke.py"], cwd=str(tmp_path),
                PYTHONPATH="")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
