"""Port parity: the brute-force oracle (ref/tracer.py) against the JAX
package's oracle, and against the committed oracle goldens; the backend
"reference" computes on the host CPU."""

import os

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as J
import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu.ref import render_reference as j_reference
from opencl_ray_tracer_tpu_torch.ref import render_reference
from opencl_ray_tracer_tpu_torch.ref.tracer import _render_oracle
from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays, scene_to_arrays
from opencl_ray_tracer_tpu_torch.utils import pack_rgba, read_png

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = torch.device("cpu")
W, H = 160, 120
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
PINHOLE = dict(position=(320.0, 240.0, 60.0), look_at=(320.0, 240.0, -85.0),
               fov_degrees=80.0, width=W, height=H)


def _scene(num):
    js = J.create_scene1() if num == 1 else J.create_scene2(seed=7)
    return js, scene_from_arrays(scene_to_arrays(js), CPU)


@pytest.mark.parametrize("num", [1, 2])
@pytest.mark.parametrize("cam", ["ortho", "pinhole"])
def test_oracle_legacy_int_parity(num, cam):
    js, ts = _scene(num)
    cfg = J.RenderConfig(width=W, height=H, shading="legacy")
    if cam == "ortho":
        jc, tc = J.legacy_ortho_camera(), T.legacy_ortho_camera(device=CPU)
    else:
        jc, tc = J.pinhole_camera(**PINHOLE), T.pinhole_camera(**PINHOLE, device=CPU)
    want = np.asarray(j_reference(js, jc, cfg))
    got = render_reference(ts, tc, T.RenderConfig(width=W, height=H)).numpy()
    assert got.dtype == np.int32 and got.shape == (H, W, 4)
    same = np.all(got == want, axis=-1).mean()
    assert same >= 0.999, f"only {same:.4%} identical"


@pytest.mark.parametrize("num", [1, 2])
@pytest.mark.parametrize("shading", ["lambert", "phong"])
def test_oracle_shaded_float_parity(num, shading):
    js, ts = _scene(num)
    kw = dict(width=W, height=H, shading=shading, shadows=True,
              framebuffer_dtype="float")
    want = np.asarray(j_reference(js, J.legacy_ortho_camera(), J.RenderConfig(**kw)))
    got = render_reference(ts, T.legacy_ortho_camera(device=CPU),
                           T.RenderConfig(**kw)).numpy()
    close = (np.abs(got - want).max(axis=-1) < 0.5).mean()
    assert close >= 0.995, f"only {close:.4%} within 0.5/255"


@pytest.mark.parametrize(
    "name,num,shading,shadows",
    [
        ("scene1_legacy", 1, "legacy", False),
        ("scene2_legacy", 2, "legacy", False),
        ("scene1_phong", 1, "phong", True),
    ],
)
def test_oracle_golden(name, num, shading, shadows):
    """The committed oracle goldens (tests/test_golden.py CASES), at that
    file's byte-level bar."""
    cfg = T.RenderConfig(width=W, height=H, shading=shading, shadows=shadows,
                         framebuffer_dtype="int" if shading == "legacy" else "float")
    scene = T.create_scene(num, seed=0, device=CPU)
    got = pack_rgba(render_reference(scene, T.legacy_ortho_camera(device=CPU), cfg))
    want = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))
    same = np.all(got == want, axis=-1).mean()
    assert same > 0.999, f"{name}: only {same:.4%} identical to golden"


@pytest.mark.parametrize("fmt", ["int", "float", "packed"])
def test_reference_backend_returns_the_cpu_oracle_frame(fmt):
    """render(..., backend="reference") and Renderer.render_cpu return a CPU
    tensor equal to _render_oracle on the same CPU scene (the card case is
    in tests/test_torch_kernels_gpu.py)."""
    scene = T.create_scene(2, seed=3, device=CPU)
    cam = T.pinhole_camera(**PINHOLE, device=CPU)
    cfg = T.RenderConfig(width=W, height=H, shading="phong", shadows=True,
                         framebuffer_dtype=fmt)
    got = T.render(scene, cam, cfg, backend="reference")
    assert got.device.type == "cpu"
    want = _render_oracle(scene, cam, cfg.replace(framebuffer_dtype="float"))
    if fmt == "packed":
        from opencl_ray_tracer_tpu_torch.ops.shading import pack_framebuffer_words

        want = pack_framebuffer_words(want)
    elif fmt == "int":
        want = _render_oracle(scene, cam, cfg)
    assert torch.equal(got, want)
    cpu = T.Renderer(cfg.replace(framebuffer_dtype="int"), cam).render_cpu(scene)
    assert torch.equal(cpu, _render_oracle(scene, cam, cfg.replace(framebuffer_dtype="int")))


def test_camera_to_keeps_the_camera():
    cam = T.pinhole_camera(**PINHOLE, device=CPU)
    moved = cam.to(CPU)
    assert moved.normalize is cam.normalize
    for name in ("o0", "dox", "doy", "d0", "ddx", "ddy"):
        assert torch.equal(getattr(moved, name), getattr(cam, name))
