"""Port parity of utils/: mathutil on a seeded grid, every texture op on
seeded RGBA images (host-int and tensor positions), render_ansi, and the
timer, memory and platform reports on the CPU."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_ray_tracer_tpu.utils import mathutil as jm
from opencl_ray_tracer_tpu.utils import render_ansi as j_render_ansi
from opencl_ray_tracer_tpu.utils import texture as jt
from opencl_ray_tracer_tpu_torch.utils import mathutil as tm
from opencl_ray_tracer_tpu_torch.utils import memory, platform_info
from opencl_ray_tracer_tpu_torch.utils import render_ansi, show, time_fn
from opencl_ray_tracer_tpu_torch.utils import texture as tt
from opencl_ray_tracer_tpu_torch.utils.timer import (
    DeltaTime,
    PerformanceCounter,
    SimpleTimer,
    fence,
    now_ns,
)

torch.set_num_threads(2)


def test_mathutil_matches_jax_on_a_seeded_grid():
    rng = np.random.default_rng(0)
    vals = rng.uniform(-500, 500, 64).tolist()
    for v in vals:
        for vmax, vmin in ((180.0, 0.0), (32767.0, -32768.0), (1.0, -1.0)):
            assert tm.normalise_float(v, vmax, vmin) == jm.normalise_float(v, vmax, vmin)
            assert (tm.normalise_between_minus1_and_1(v, vmax, vmin)
                    == jm.normalise_between_minus1_and_1(v, vmax, vmin))
        assert tm.deg_to_rad(v) == jm.deg_to_rad(v)
        assert tm.rad_to_deg(v) == jm.rad_to_deg(v)
    rects = [tuple(rng.uniform(-20, 60, 2)) + tuple(rng.uniform(0, 40, 2))
             for _ in range(24)]
    pts = rng.uniform(-30, 110, (48, 2)).tolist()
    segs = rng.integers(-30, 110, (48, 4)).tolist()  # ints: exact crossings too
    segs += [[0, 0, 10, 10], [0, 10, 10, 0], [0, 0, 1, 1], [5, 5, 6, 6]]
    for r in rects:
        a, b = tm.Rect(*r), jm.Rect(*r)
        assert a.center == b.center
        for r2 in rects:
            assert tm.rects_intersect(a, tm.Rect(*r2)) == jm.rects_intersect(b, jm.Rect(*r2))
        for p in pts:
            assert tm.point_in_rect(*p, a) == jm.point_in_rect(*p, b)
        for s in segs:
            assert (tm.line_rect_intersect(s[:2], s[2:], a)
                    == jm.line_rect_intersect(s[:2], s[2:], b))
    for s in segs:
        for s2 in segs:
            got = tm.line_intersect(s[:2], s[2:], s2[:2], s2[2:])
            assert got == jm.line_intersect(s[:2], s[2:], s2[:2], s2[2:])


def _rgba(rng, h, w, alpha=True):
    img = rng.uniform(0, 255, (h, w, 4)).astype(np.float32)
    if not alpha:
        img[..., 3] = 255.0
    return img


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("pos", [(3, 5), (-4, -2), (30, 20), (12, -9), (100, 100),
                                 (-40, 0)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_blit_matches_jax(dtype, pos, as_tensor):
    """Alpha blit of a seeded 9x13 image onto a seeded 32x40 framebuffer:
    host-int positions (sliced update) and tensor positions (masked
    full-frame blend), within 1e-5 of JAX's (int frames truncate alike)."""
    rng = np.random.default_rng(abs(hash(pos)) % 1000)
    dest = _rgba(rng, 32, 40).astype(dtype)
    src = _rgba(rng, 9, 13)
    if as_tensor:
        want = jt.blit(dest, src, (jnp.int32(pos[0]), jnp.int32(pos[1])))
        got = tt.blit(torch.from_numpy(dest), torch.from_numpy(src),
                      (torch.tensor(pos[0]), torch.tensor(pos[1])))
    else:
        want = jt.blit(dest, src, pos)
        got = tt.blit(torch.from_numpy(dest), src, pos)
    _close(got, want)
    # both paths are one function
    other = tt.blit(torch.from_numpy(dest), src,
                    pos if as_tensor else tuple(torch.tensor(p) for p in pos))
    _close(got, other.numpy())


@pytest.mark.parametrize("out_hw", [(4, 6), (17, 5), (3, 3), (40, 31)])
def test_resize_nearest_matches_jax(out_hw):
    img = _rgba(np.random.default_rng(1), 7, 11)
    _close(tt.resize_nearest(torch.from_numpy(img), *out_hw),
           jt.resize_nearest(img, *out_hw))


@pytest.mark.parametrize("degrees,pivot", [(90.0, (1.5, 1.5)), (90.0, None),
                                           (33.0, None), (-120.0, (2.0, 7.0)),
                                           (180.0, None)])
def test_texture_draw_rotated_scaled_tinted_matches_jax(degrees, pivot):
    rng = np.random.default_rng(2)
    src = _rgba(rng, 12, 9)
    dest = _rgba(rng, 24, 30, alpha=False)
    jtex, ttex = jt.Texture(src), tt.Texture(torch.from_numpy(src))
    assert ttex.dimensions == jtex.dimensions == (9, 12)
    _close(tt._rotate_rgba(torch.from_numpy(src), degrees, pivot),
           jt._rotate_rgba(src, degrees, pivot))
    _close(ttex.draw(torch.from_numpy(dest), (4, 3), rotation_degrees=degrees,
                     pivot=pivot),
           jtex.draw(dest, (4, 3), rotation_degrees=degrees, pivot=pivot))
    for tint in ((255, 128, 0), (0.25, 1.0, 0.5)):
        jtt, ttt = jtex.set_colour_tint(*tint), ttex.set_colour_tint(*tint)
        assert ttt.tint == jtt.tint
        _close(ttt.draw_scaled(torch.from_numpy(dest), (-2, 5), (20, 7)),
               jtt.draw_scaled(dest, (-2, 5), (20, 7)))
    with pytest.raises(ValueError):
        tt.Texture(np.zeros((4, 4, 3), np.float32))


def test_render_ansi_matches_jax():
    """The same string as JAX's for the same image: int, float, and the
    packed words of the same frame; tensors are copied to the host."""
    rng = np.random.default_rng(3)
    fb = rng.integers(-20, 280, (37, 53, 4)).astype(np.int32)
    for kw in ({}, {"max_width": 16, "max_height": 5}, {"max_width": 200}):
        want = j_render_ansi(fb, **kw)
        assert render_ansi(torch.from_numpy(fb), **kw) == want
        assert render_ansi(fb, **kw) == want
        assert render_ansi(torch.from_numpy(fb.astype(np.float32) + 0.25), **kw) == want
        words = np.clip(fb, 0, 255).astype(np.uint8).view("<i4")[..., 0]
        assert render_ansi(torch.from_numpy(words.copy()), **kw) == want


def test_show_prints(capsys):
    show(np.zeros((4, 4, 4), np.int32), max_width=4)
    assert "\x1b[38;2;0;0;0m" in capsys.readouterr().out


def test_timers():
    t = PerformanceCounter()
    with pytest.raises(RuntimeError):
        t.stop_counter()
    t.start_counter()
    assert t.stop_counter() >= 0 and t.elapsed_us >= 0
    dt = DeltaTime()
    assert dt.update() >= 0
    assert SimpleTimer(0.0).expired and not SimpleTimer(3600.0).expired
    assert isinstance(now_ns(), int)


def test_time_fn_keys_and_cpu_fence():
    calls = []

    def fn():
        calls.append(1)
        return (torch.ones(3), torch.zeros(2))

    fence(fn())  # CPU tensors: nothing to wait for
    stats = time_fn(fn, iters=3, warmup=2, batches=4)
    assert set(stats) == {"mean_us", "median_us", "min_us", "max_us",
                          "stdev_us", "iters"}
    assert stats["iters"] == 12.0 and len(calls) == 1 + 2 + 12
    assert 0 <= stats["min_us"] <= stats["median_us"] <= stats["max_us"]
    assert math.isfinite(stats["stdev_us"])


def test_memory_and_platform_on_cpu():
    assert memory.get_host_memory_usage_bytes() > 10_000_000
    rep = memory.format_memory_report()
    assert rep.startswith("host rss: ")
    stats = memory.get_device_memory_stats()
    assert len(stats) == torch.cuda.device_count()
    info = platform_info.system_info()
    for key in ("os", "python", "torch", "cuda", "backend", "devices",
                "process_count", "cpu_count", "cpu_features", "host_rss_mb"):
        assert key in info
    assert info["backend"] == ("gpu" if torch.cuda.is_available() else "cpu")
    assert len(info["devices"]) >= 1 and info["process_count"] == 1
    platform_info.log_system_info()


def test_rng_module_singleton_matches_jax():
    """The module-level init / get_int / get_float over one shared Random,
    as the JAX package's utils/rng.py: the same draws from the same seed."""
    from opencl_ray_tracer_tpu.utils import rng as jr
    from opencl_ray_tracer_tpu_torch.utils import rng as tr

    for seed in (0, 7, 12345):
        jr.init(seed)
        tr.init(seed)
        want = [jr.get_int(-5, 9) for _ in range(8)] + [jr.get_float(-1.0, 2.5)
                                                       for _ in range(8)]
        got = [tr.get_int(-5, 9) for _ in range(8)] + [tr.get_float(-1.0, 2.5)
                                                      for _ in range(8)]
        assert got == want
    assert isinstance(tr._global, tr.Random)


def test_now_ns_matches_jax_clock_kind():
    """`now_ns` is a function of the monotonic clock in nanoseconds, as
    JAX's utils/timer.now_ns."""
    import time

    from opencl_ray_tracer_tpu.utils import timer as jtimer
    from opencl_ray_tracer_tpu_torch.utils import timer as ttimer

    a = ttimer.now_ns()
    b = jtimer.now_ns()
    c = time.perf_counter_ns()
    assert callable(ttimer.now_ns) and isinstance(a, int) and isinstance(b, int)
    assert a <= c and abs(b - a) < 10**9
