"""B1's per-warp cull of the pinhole shadow rows, on the card: the culled
frame against the plain twin, which walks every row, and the card counters
`b1.shadow_rows` / `b1.shadow_rows_kept`.

These need an NVIDIA card and nvcc (the kernel has no CPU mode), so they
skip where torch.cuda.is_available() is false. Run them on the card with:

    python -m pytest tests/test_torch_shadow_cull_gpu.py -q

Bars: tests/test_torch_kernels_gpu.py's (float frames within 0.5/255 of the
twin; packed words within one level a channel and identical on >= 99.5% of
pixels). An occluder the cull dropped lights a shadowed pixel, which moves
it by far more than a level.
"""

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
from opencl_ray_tracer_tpu_torch.utils import tracing, unpack_words

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs an NVIDIA card: the CUDA kernel has no CPU mode")

W, H = 640, 480


def _inputs(scene, fmt, camera="front"):
    dev = scene.sphere_origin.device
    if camera == "front":
        cam = T.pinhole_camera((320.0, 240.0, 60.0), (320.0, 240.0, -85.0),
                               fov_degrees=80.0, width=W, height=H, device=dev)
    else:  # among the primitives, looking across them
        cam = T.pinhole_camera((100.0, 120.0, -40.0), (500.0, 300.0, -70.0),
                               fov_degrees=70.0, width=W, height=H, device=dev)
    cfg = T.RenderConfig(width=W, height=H, shading="phong", shadows=True,
                         framebuffer_dtype=fmt)
    packed = scene.pack()
    bins = fwd_tiled.bin_for_config(packed, cam, cfg)
    return fwd_tiled.kernel_inputs(packed, cam, bins, height=H, width=W,
                                   shading="phong", shadows=True, out_format=fmt)


def _lights(n, dev):
    if n == 1:
        return T.Lights.default(dev)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    pos = [[200.0, 100.0, 200.0], [600.0, 300.0, 150.0], [-100.0, 500.0, 80.0]]
    return T.Lights(position=f(pos[:n]), colour=f([[1.0, 0.9, 0.8]] * n),
                    intensity=f([0.6] * n), ambient=f(0.1), spec_strength=f(0.5),
                    shininess=f(32.0))


def _counts():
    return [tracing.counter(n) for n in fwd_tiled._CULL_COUNTERS]


def _assert_twin(got, want, fmt):
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


@pytest.mark.parametrize("fmt,n_lights,camera", [
    ("packed", 1, "front"),
    ("float", 1, "front"),
    ("packed", 3, "front"),
    ("float", 2, "inside"),
])
def test_culled_frame_matches_twin(fmt, n_lights, camera):
    dev = torch.device("cuda")
    scene = T.create_scene(3, seed=0, lights=_lights(n_lights, dev), device=dev)
    args, kw = _inputs(scene, fmt, camera)
    counts = args[1]
    assert int(counts[0, 2]) + int(counts[0, 3]) > 32  # the lists B1 culls
    rows0, kept0 = _counts()
    got = fwd_tiled.tiled_kernel(*args, **kw)
    torch.cuda.synchronize()
    rows, kept = (v - v0 for v, v0 in zip(_counts(), (rows0, kept0)))
    assert rows > 0, "no warp culled"
    assert 0.0 < 100.0 * kept / rows < 100.0
    _assert_twin(got, fwd_tiled._tiled_kernel_plain(*args, **kw), fmt)


def test_short_lists_are_not_culled():
    """rt10's pinhole list (10 spheres and one cube's 12 triangles) is
    shorter than a warp: B1 walks it whole and counts nothing."""
    dev = torch.device("cuda")
    scene = T.random_scene(10, 1, seed=11, bounds=(W, H), device=dev)
    args, kw = _inputs(scene, "packed")
    counts = args[1]
    assert int(counts[0, 2]) + int(counts[0, 3]) <= 32
    before = _counts()
    got = fwd_tiled.tiled_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert _counts() == before
    _assert_twin(got, fwd_tiled._tiled_kernel_plain(*args, **kw), "packed")


def test_replayed_frame_counts_its_cull():
    """A captured B1 adds to the counters at each replay (the counters are
    made by the eager launch before the capture)."""
    from opencl_ray_tracer_tpu_torch.runtime import graph

    dev = torch.device("cuda")
    scene = T.create_scene(3, seed=0, device=dev)
    args, kw = _inputs(scene, "packed")
    eager = fwd_tiled.tiled_kernel(*args, **kw)
    torch.cuda.synchronize()
    step = graph.jit(lambda *a: fwd_tiled.tiled_kernel(*a, **kw))
    first = step(*args).clone()
    torch.cuda.synchronize()
    before = _counts()
    again = step(*args)
    torch.cuda.synchronize()
    after = _counts()
    assert after[0] > before[0] and after[1] > before[1]
    assert torch.equal(first, eager) and torch.equal(again, eager)
