"""The port's examples (examples/torch_*.py) run with --device cpu at the
sizes of tests/test_examples.py, in a subprocess as a user runs them, and
write their PNGs; the flythrough's frame 0 is held against the JAX
package's oracle on the same camera."""

import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as J
from opencl_ray_tracer_tpu_torch.kernels.fwd_tiled import render_tiled
from opencl_ray_tracer_tpu_torch.utils import pack_rgba, read_png

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args):
    return subprocess.run(
        [sys.executable, os.path.join("examples", script), *args],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "2"},
    )


def _load(script):
    spec = importlib.util.spec_from_file_location(
        script[:-3], os.path.join(REPO, "examples", script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flythrough_demo(tmp_path):
    prefix = str(tmp_path / "fly")
    argv = ["--device", "cpu", "--frames", "2", "--width", "256", "--height",
            "128", "--png-prefix", prefix]
    proc = _run("torch_flythrough_demo.py", *argv)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert re.search(r"2 frames at 256x128 on cpu: .* fps \(.* rays/s", proc.stdout)
    assert os.path.exists(prefix + "001.png")

    # frame 0: the example's scene and camera through the tiled path (the
    # kernel's twin on the CPU) against JAX's oracle on the same camera,
    # at the B1-vs-oracle bar (>= 99.5% of pixels within 0.5/255)
    mod = _load("torch_flythrough_demo.py")
    args = mod.parse_args(argv)
    scene, cfg, camera_at = mod.setup(args)
    assert (cfg.shading, cfg.shadows, cfg.framebuffer_dtype) == ("phong", True, "float")
    frame0 = render_tiled(scene, camera_at(0.0), cfg)
    np.testing.assert_array_equal(read_png(prefix + "000.png"), pack_rgba(frame0))
    cam = camera_at(0.0)
    jcam = J.pinhole_camera(
        position=tuple(cam.o0.tolist()), look_at=(320.0, 240.0, -60.0),
        fov_degrees=55.0, width=256, height=128)
    np.testing.assert_array_equal(np.asarray(jcam.d0), cam.d0.numpy())
    want = np.asarray(J.render(J.create_scene(2, seed=0), jcam,
                               J.RenderConfig(**{k: getattr(cfg, k) for k in (
                                   "width", "height", "shading", "shadows",
                                   "framebuffer_dtype")}),
                               backend="reference"))
    err = np.abs(frame0.numpy() - want).max(axis=-1)
    assert (err < 0.5).mean() >= 0.995, (err < 0.5).mean()
    assert (np.abs(want - [0, 0, 0, 255]).max(axis=-1) > 0).mean() > 0.05  # lit


def test_inverse_rendering_demo(tmp_path):
    prefix = str(tmp_path / "inv")
    proc = _run("torch_inverse_rendering_demo.py", "--device", "cpu", "--width",
                "128", "--height", "64", "--steps", "3", "--out-prefix", prefix)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for part in ("target", "init", "fitted"):
        assert read_png(f"{prefix}_{part}.png").shape == (64, 128, 4)
    first, last = map(float, re.search(r"loss: (\S+) -> (\S+)", proc.stdout).groups())
    assert last < first
    assert "mesh: (1,)" in proc.stdout


@pytest.mark.parametrize("script", ["torch_flythrough_demo.py",
                                    "torch_inverse_rendering_demo.py"])
def test_examples_need_a_card_by_default(script):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    proc = _run(script)
    assert proc.returncode != 0
    assert "no CUDA device is visible" in proc.stderr
