"""The CUDA tiled kernel against its plain torch twin, on the card.

These need an NVIDIA card and nvcc (the kernel has no CPU mode), so they
skip where torch.cuda.is_available() is false. Run them on the card with:

    python -m pytest tests/test_torch_kernels_gpu.py -q

Bars, on every pixel: float frames within 0.5/255 of the twin, packed words
within one step of 1/255 per channel (a value that lands on a rounding edge
can round the other way when the two sides differ in the last ulp) and
identical on >= 99.5% of pixels. On an H100 the largest differences read
0.22 (float) and 1 (packed).
"""

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
from opencl_ray_tracer_tpu_torch.utils import unpack_words

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

pytestmark = pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs an NVIDIA card: the CUDA kernel has no CPU mode")

W, H = 640, 480


@pytest.fixture(scope="module")
def cuda_device():
    return torch.device("cuda")


def _inputs(device, scene_num, cam_kind, shading, shadows, fmt):
    scene = T.create_scene(scene_num, seed=0, device=device)
    if cam_kind == "ortho":
        cam = T.legacy_ortho_camera(device=device)
    else:
        cam = T.pinhole_camera((320.0, 240.0, 60.0), (320.0, 240.0, -85.0),
                               fov_degrees=80.0, width=W, height=H,
                               device=device)
    cfg = T.RenderConfig(width=W, height=H, shading=shading, shadows=shadows,
                         framebuffer_dtype=fmt)
    packed = scene.pack()
    bins = fwd_tiled.bin_for_config(packed, cam, cfg)
    return fwd_tiled.kernel_inputs(packed, cam, bins, height=H, width=W,
                                   shading=shading, shadows=shadows,
                                   out_format=fmt)


@pytest.mark.parametrize(
    "scene_num,cam_kind,shading,shadows,fmt",
    [
        (1, "ortho", "legacy", False, "packed"),
        (1, "ortho", "phong", True, "float"),
        (2, "ortho", "lambert", True, "packed"),
        (2, "pinhole", "phong", True, "float"),
        (3, "ortho", "phong", True, "packed"),
        (3, "pinhole", "legacy", False, "float"),
    ],
)
def test_kernel_matches_twin(cuda_device, scene_num, cam_kind, shading,
                             shadows, fmt):
    args, kw = _inputs(cuda_device, scene_num, cam_kind, shading, shadows, fmt)
    before = fwd_tiled.KERNEL_LAUNCHES
    got = fwd_tiled.tiled_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert fwd_tiled.KERNEL_LAUNCHES == before + 1
    want = fwd_tiled._tiled_kernel_plain(*args, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    if fmt == "packed":
        err = np.abs(unpack_words(got).astype(np.int32)
                     - unpack_words(want).astype(np.int32)).max(axis=-1)
        assert err.max() <= 1, f"packed byte error {err.max()} > 1"
        frac = (err == 0).mean()
        assert frac >= 0.995, f"only {frac:.4%} of pixels identical"
    else:
        err = (got - want).abs().max().item()
        assert err < 0.5, f"float error {err} >= 0.5"


def test_wrapper_rejects_bad_inputs(cuda_device):
    args, kw = _inputs(cuda_device, 1, "ortho", "legacy", False, "packed")
    bad = list(args)
    bad[1] = args[1].to(torch.int64)
    with pytest.raises(TypeError):
        fwd_tiled.tiled_kernel(*bad, **kw)
    bad = list(args)
    bad[2] = args[2].transpose(0, 1)
    with pytest.raises(ValueError):
        fwd_tiled.tiled_kernel(*bad, **kw)
    with pytest.raises(ValueError):
        fwd_tiled.tiled_kernel(*args, **{**kw, "width": W + 256})
