#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's two paths — the tiled hard forward frame and the soft
differentiable train step — through the entry points a user calls, and
fails (non-zero exit, no result line) unless every phase passes:

1. device: torch, CUDA and nvcc versions, the card's name and power limit;
2. build: nvcc builds kernels/csrc/{fwd_tiled,soft_tiled}.cu from this
   checkout, one nvcc per source, in parallel;
3. kernel vs plain twin at 640x480: scenes 1-3, legacy/lambert/phong with
   and without shadows, ortho and pinhole cameras, packed/int/float frames;
4. the committed goldens through the kernel at 160x120;
5. the main path at full size: the bench headline frame (10 spheres +
   1 cube, 1920x1080, phong + hard shadows, packed words, legacy ortho
   camera) through models.renderer.render(backend="pallas"), and the
   640x480 scene-1 frame of the JAX package's entry(); launch counts, a
   check against the twin and the oracle, and CUDA-event timings of the
   kernel, its twin and the whole frame;
6. where the time goes: the frame's stages timed back to back in one loop
   (they add up to the frame), and a device trace of 20 frames for kernels
   per frame and the device's busy share;
7. the soft kernels B4 (forward) and B5 (backward) against their plain
   twin at 256x128: two scenes, ortho and pinhole, legacy / lambert /
   lambert + shadows / phong + shadows; images within 0.05/255 on every
   pixel, every scene leaf's gradient within 1e-3 of the twin's normalised
   by its largest (2e-3 pinhole); then 16 pixel-gradient Jacobian rows
   (bench.py:434-460) within 1e-4 of the twin's and of diff.render_soft's;
8. the soft golden (pallas_soft_scene1_phong) through the kernels;
9. the train path at full size: (a) 10 Adam steps of the bench's 1080p
   phong + soft-shadow train step through make_train_step, step 1's
   gradients held against the twin's, the kernels', twin's and whole
   step's CUDA-event times and a device trace of the step; (b) the CLI's
   `fit --scene 1 --steps 60` at 640x480, which must lower the loss and the
   sphere-origin error.

Hard kernel vs twin is bounded on every pixel: float frames within 0.5/255,
packed and int frames within one step of 1/255 (and identical on >= 99.5%
of pixels).

The second-to-last stdout line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Needs no network and imports no JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _time_ms(fn, n, warmup=3):
    """Median, min, max milliseconds per call over n calls (CUDA events
    around each call; the host's own stalls inside the call count)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), min(times), max(times)


def _back_to_back_ms(fn, n):
    """Milliseconds per call over n calls issued back to back between two
    CUDA events: the device time of a launch once the host runs ahead."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


BACKGROUND = -16777216  # 0xFF000000 as int32: opaque black, no hit


def _errors(got, want, fmt):
    """Per-pixel error, the largest over the four channels: bytes for
    packed words, values (0-255 scale) for int and float frames."""
    import torch

    if fmt == "packed":
        got = got.view(torch.uint8).reshape(*got.shape, 4)
        want = want.view(torch.uint8).reshape(*want.shape, 4)
    return (got.float() - want.float()).abs().amax(dim=-1)


def _check_twin(label, got, want, fmt):
    """Kernel vs its plain twin, bounded on every pixel: float within
    0.5/255, packed and int within one step (a value on a rounding edge may
    round the other way when the two sides differ in the last ulp) and
    identical on >= 99.5% of pixels."""
    err = _errors(got, want, fmt)
    max_err = err.max().item()
    same = (err == 0).float().mean().item()
    print(f"{label} {fmt}: {same:.6f} identical, max err {max_err:.4f}")
    bound_ok = (max_err < 0.5 if fmt == "float" else
                max_err <= 1 and same >= 0.995)
    _require(bound_ok, f"{label} {fmt}: kernel vs twin max err {max_err}, "
                       f"{same} identical")
    return max_err


def _lit_agreement(got, want):
    """Share of the pixels lit in either float frame (not the (0,0,0,255)
    background) on which the two agree within 0.5/255."""
    import torch

    bg = torch.tensor([0.0, 0.0, 0.0, 255.0], device=got.device)
    lit = (got != bg).any(dim=-1) | (want != bg).any(dim=-1)
    ok = _errors(got, want, "float") < 0.5
    return ok[lit].float().mean().item(), lit.float().mean().item()


def _device_profile(fn, n):
    """Device kernels per call, the device's busy share of the wall time
    (the union of kernel intervals), device ms per call, and the six
    kernel names with the most device time per call (ms), from a
    torch.profiler trace of n calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    _require(spans, "the profiler saw no device work")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (len(spans) / n, busy / wall_us, busy / n / 1e3,
            [(name[:60], us / n / 1e3) for name, us in top])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: this smoke runs on the card")

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import opencl_ray_tracer_tpu_torch as T
    from opencl_ray_tracer_tpu_torch.kernels import _build, fwd_tiled
    from opencl_ray_tracer_tpu_torch.models.renderer import render
    from opencl_ray_tracer_tpu_torch.ops.shading import pack_framebuffer_words
    from opencl_ray_tracer_tpu_torch.ref import render_reference
    from opencl_ray_tracer_tpu_torch.utils import pack_rgba, read_png

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    kind = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"[device] nvcc: {nvcc}")
    print(f"[device] {kind}; nvidia-smi: {smi}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    print(f"[build] {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS} s)")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # ---- 3. kernel vs plain twin at 640x480 ------------------------------
    w, h = 640, 480
    before = fwd_tiled.KERNEL_LAUNCHES
    n_cases = 0
    worst = 0.0
    for num in (1, 2, 3):
        scene = T.create_scene(num, seed=0, device=dev)
        packed = scene.pack()
        for cam_kind in ("ortho", "pinhole"):
            cam = (T.legacy_ortho_camera(device=dev) if cam_kind == "ortho" else
                   T.pinhole_camera((320.0, 240.0, 60.0), (320.0, 240.0, -85.0),
                                    fov_degrees=80.0, width=w, height=h,
                                    device=dev))
            for shading, shadows in (("legacy", False), ("lambert", True),
                                     ("phong", True), ("phong", False)):
                cfg = T.RenderConfig(width=w, height=h, shading=shading,
                                     shadows=shadows)
                bins = fwd_tiled.bin_for_config(packed, cam, cfg)
                for fmt in ("packed", "float"):
                    args, kw = fwd_tiled.kernel_inputs(
                        packed, cam, bins, height=h, width=w, shading=shading,
                        shadows=shadows, out_format=fmt)
                    got = fwd_tiled.tiled_kernel(*args, **kw)
                    torch.cuda.synchronize()
                    want = fwd_tiled._tiled_kernel_plain(*args, **kw)
                    pairs = [(fmt, got, want)]
                    if fmt == "float":
                        pairs.append(("int", torch.trunc(got).int(),
                                      torch.trunc(want).int()))
                    for f, a, b in pairs:
                        err = _check_twin(f"[parity] scene{num} {cam_kind} "
                                          f"{shading} shadows={shadows}", a, b, f)
                        n_cases += 1
                        if f == "float":
                            worst = max(worst, err)
    launched = fwd_tiled.KERNEL_LAUNCHES - before
    _require(launched > 0, "the parity phase launched no kernel")
    print(f"[parity] {n_cases} comparisons, largest float error {worst:.4f} "
          f"(bar < 0.5; packed and int bar <= 1), {launched} kernel launches")

    # ---- 4. goldens through the kernel at 160x120 ------------------------
    gdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "golden")
    gw, gh = 160, 120
    scenes = {n: T.create_scene(n, seed=0, device=dev) for n in (1, 2)}
    for name, num, shading, shadows, cam_kind, bar in (
        ("pallas_scene1_legacy", 1, "legacy", False, "ortho", 0.999),
        ("pallas_scene1_phong", 1, "phong", True, "ortho", 0.999),
        ("pallas_scene1_pinhole", 1, "legacy", False, "pinhole", 0.999),
        ("pallas_scene1_pinhole_phong", 1, "phong", True, "pinhole", 0.999),
        ("scene1_legacy", 1, "legacy", False, "ortho", 0.995),
        ("scene2_legacy", 2, "legacy", False, "ortho", 0.995),
        ("scene1_phong", 1, "phong", True, "ortho", 0.995),
    ):
        cam = (T.legacy_ortho_camera(device=dev) if cam_kind == "ortho" else
               T.pinhole_camera((320.0, 240.0, 60.0), (320.0, 240.0, -85.0),
                                fov_degrees=80.0, width=gw, height=gh,
                                device=dev))
        cfg = T.RenderConfig(width=gw, height=gh, shading=shading,
                             shadows=shadows,
                             framebuffer_dtype="int" if shading == "legacy" else "float")
        got = pack_rgba(fwd_tiled.render_tiled(scenes[num], cam, cfg))
        want = read_png(os.path.join(gdir, f"{name}.png"))
        same = float((got == want).all(axis=-1).mean())
        print(f"[golden] {name}: {same:.6f} identical (bar {bar})")
        _require(same >= bar, f"golden {name} below its bar: {same}")

    # ---- 5. main path at full size ----------------------------------------
    headline = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
    hl_cfg = T.RenderConfig(width=1920, height=1080, shading="phong",
                            shadows=True, framebuffer_dtype="packed")
    ortho = T.legacy_ortho_camera(device=dev)
    entry_scene = T.create_scene1(device=dev)
    entry_cfg = T.RenderConfig(width=640, height=480, shading="phong",
                               shadows=True, framebuffer_dtype="packed")

    fwd_tiled.KERNEL_LAUNCHES = 0
    hl_out = render(headline, ortho, hl_cfg, backend="pallas")
    entry_out = fwd_tiled.render_tiled(entry_scene, ortho, entry_cfg)
    torch.cuda.synchronize()
    main_launches = fwd_tiled.KERNEL_LAUNCHES
    print(f"[main] kernel launches in the main-path run: {main_launches}")
    _require(main_launches >= 2, "the main path did not go through the kernel")

    kernel_rows = []
    for label, scene, cfg, out in (
        ("headline 1920x1080 10sph+1cube phong+shadows packed", headline,
         hl_cfg, hl_out),
        ("entry 640x480 scene1 phong+shadows packed", entry_scene, entry_cfg,
         entry_out),
    ):
        _require(tuple(out.shape) == (cfg.height, cfg.width)
                 and out.dtype == torch.int32, f"{label}: bad frame {out.shape}")
        packed = scene.pack()
        bins = fwd_tiled.bin_for_config(packed, ortho, cfg)
        args, kw = fwd_tiled.kernel_inputs(
            packed, ortho, bins, height=cfg.height, width=cfg.width,
            shading=cfg.shading, shadows=cfg.shadows, out_format="packed")
        twin = fwd_tiled._tiled_kernel_plain(*args, **kw)
        _check_twin(f"[main] {label}: main path vs twin", out, twin, "packed")
        # the same frame as float RGBA: kernel vs twin (max_abs_err), and
        # kernel vs the brute-force oracle (no culling, no tables), which may
        # break a last-bit tie the other way on a few edge pixels
        fargs, fkw = fwd_tiled.kernel_inputs(
            packed, ortho, bins, height=cfg.height, width=cfg.width,
            shading=cfg.shading, shadows=cfg.shadows, out_format="float")
        fk = fwd_tiled.tiled_kernel(*fargs, **fkw)
        _require(bool(torch.isfinite(fk).all()), f"{label}: non-finite pixels")
        ferr = _check_twin(f"[main] {label}: kernel vs twin", fk,
                           fwd_tiled._tiled_kernel_plain(*fargs, **fkw), "float")
        fo = render_reference(scene, ortho, cfg.replace(framebuffer_dtype="float"))
        ofrac, lit = _lit_agreement(fk, fo)
        pfrac = (_errors(out, pack_framebuffer_words(fo), "packed") == 0
                 ).float().mean().item()
        print(f"[main] {label}: vs oracle {ofrac:.6f} of the lit pixels "
              f"within 0.5/255 (bar 0.995), packed {pfrac:.6f} of all pixels "
              f"identical; {lit:.4f} of pixels lit")
        _require(ofrac >= 0.995, f"{label}: kernel vs oracle {ofrac}")
        _require(lit > 0.001, f"{label}: empty frame")

        n = 60
        k_ms = _time_ms(lambda: fwd_tiled.tiled_kernel(*args, **kw), n)
        kf_ms = _time_ms(lambda: fwd_tiled.tiled_kernel(*fargs, **fkw), n)
        p_ms = _time_ms(lambda: fwd_tiled._tiled_kernel_plain(*args, **kw), 50)
        f_ms = _time_ms(lambda: fwd_tiled.render_tiled(scene, ortho, cfg), n)
        for what, (med, lo, hi) in (("kernel", k_ms),
                                    ("kernel, float output", kf_ms),
                                    ("plain twin", p_ms),
                                    ("whole render_tiled", f_ms)):
            print(f"[time] {label}: {what} median {med:.4f} ms "
                  f"[{lo:.4f}, {hi:.4f}] over >= 50 frames; {smi}")
        kernel_rows.append((label, k_ms, p_ms, ferr))

    # ---- 6. where the frame's time goes ------------------------------------
    # One loop times the stages of render_tiled back to back with CUDA
    # events, so per frame they add up to the whole; then a device trace of
    # whole frames gives kernels per frame and the device's busy share.
    for label, scene, cfg in (("headline", headline, hl_cfg),
                              ("entry", entry_scene, entry_cfg)):
        stages = ("pack", "bin_for_config", "kernel_inputs", "kernel")
        per = {name: [] for name in stages + ("frame",)}
        for i in range(53):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            packed = scene.pack()
            ev[1].record()
            bins = fwd_tiled.bin_for_config(packed, ortho, cfg)
            ev[2].record()
            args, kw = fwd_tiled.kernel_inputs(
                packed, ortho, bins, height=cfg.height, width=cfg.width,
                shading=cfg.shading, shadows=cfg.shadows,
                out_format=cfg.framebuffer_dtype)
            ev[3].record()
            fwd_tiled.tiled_kernel(*args, **kw)
            ev[4].record()
            ev[4].synchronize()
            if i < 3:  # warm-up
                continue
            for j, name in enumerate(stages):
                per[name].append(ev[j].elapsed_time(ev[j + 1]))
            per["frame"].append(ev[0].elapsed_time(ev[4]))
        parts = "; ".join(
            f"{name} mean {statistics.fmean(v):.4f} median "
            f"{statistics.median(v):.4f}" for name, v in per.items())
        print(f"[stages] {label}, ms over 50 frames: {parts}; {smi}")
        launches, busy, dev_ms, _ = _device_profile(
            lambda: fwd_tiled.render_tiled(scene, ortho, cfg), 20)
        print(f"[stages] {label}: {launches:.1f} device kernels per frame, "
              f"device busy {busy:.4f} of the wall time ({dev_ms:.4f} ms of "
              f"device work per frame), 20 traced frames; {smi}")

    soft_phase_kernel_vs_twin(T, dev)           # 7
    soft_phase_golden(T, dev, gdir)             # 8
    soft_rows = soft_phase_train(T, dev, smi)   # 9 (a)
    soft_phase_cli_fit()                        # 9 (b)

    label, k_ms, p_ms, ferr = kernel_rows[0]
    print(smi)  # name, power limit exactly as nvidia-smi gives them
    print(json.dumps({"kernels": [{
        "name": "fwd_tiled",
        "route": "cuda",
        "source": "opencl_ray_tracer_tpu_torch/kernels/csrc/fwd_tiled.cu",
        "replaces": "opencl_ray_tracer_tpu/kernels/fwd_tiled.py:514",
        "launches": main_launches,
        "max_abs_err": ferr,
        "tolerance": "every pixel: float within 0.5/255 of the twin, "
                     "packed bytes within 1; packed identical on >= 99.5%",
        "shape": label,
        "ms": k_ms[0],
        "plain_ms": p_ms[0],
    }] + soft_rows}))
    # the smoke drives one card (cuda:0), whatever else is visible
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}))
    return 0


# ---------------------------------------------------------------------------
# The soft differentiable path: B4 (forward) and B5 (backward)
# ---------------------------------------------------------------------------

SOFT_W, SOFT_H = 256, 128
SOFT_PINHOLE = dict(position=(128.0, 64.0, 200.0), look_at=(128.0, 64.0, -60.0),
                    fov_degrees=65.0, width=SOFT_W, height=SOFT_H)
SOFT_MODES = (("legacy", False), ("lambert", False), ("lambert", True),
              ("phong", True))
FWD_BAR = 0.05  # 0..255 units, every pixel


def _soft_cfg(T, w, h, shading, shadows):
    return T.RenderConfig(width=w, height=h, shading=shading, shadows=shadows,
                          soft=True, framebuffer_dtype="float", tau_depth=1.0,
                          tau_edge=0.5)


def _twin_render(scene, cam, cfg):
    """The frame through the kernels' plain twin (autograd-able), on the
    tensors' device: the same bins, tables and params as the kernels."""
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S

    params, taus, tables, counts, kc = S.soft_kernel_inputs(scene.pack(), cam, cfg)
    return S._soft_tiled_plain(params, taus, tables, counts, cfg=kc)


def _leaf_grads(render, scene, cam, cfg, loss_fn):
    import torch

    from opencl_ray_tracer_tpu_torch.parallel.train import (
        scene_leaves,
        trainable_scene,
    )

    s = trainable_scene(scene)
    leaves = scene_leaves(s)
    loss = loss_fn(render(s, cam, cfg))
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), grads)}


def _compare_grads(label, got, want, atol):
    """Every leaf: finite; normalised by the twin's largest magnitude within
    atol; non-zero wherever the twin's gradient is above 1e-6 of that
    magnitude. Returns the largest normalised error."""
    import torch

    worst = 0.0
    for k, w in want.items():
        g = got[k]
        _require(bool(torch.isfinite(g).all()), f"{label} {k}: non-finite grad")
        scale = w.abs().max().item()
        if scale == 0.0:
            _require(g.abs().max().item() == 0.0, f"{label} {k}: twin 0, kernel not")
            continue
        err = (g - w).abs().max().item() / scale
        worst = max(worst, err)
        _require(err <= atol, f"{label} {k}: normalised grad error {err} > {atol}")
        lost = ((w.abs() > 1e-6 * scale) & (g == 0)).sum().item()
        _require(lost == 0, f"{label} {k}: {lost} zero grads where the twin's is not")
    return worst


def _mean_sq(img):
    return (img[..., :3] ** 2).mean()


def soft_phase_kernel_vs_twin(T, dev):
    """Phase 7: B4/B5 against the twin at 256x128 on the card: the test
    scene and scene 1, ortho and pinhole, four shading modes. Then the 16
    pixel-gradient probes (bench.py:434-460) against the twin and the
    diff.render_soft oracle."""
    import numpy as np
    import torch

    from opencl_ray_tracer_tpu_torch.diff import render_soft
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S

    before = (S.FWD_LAUNCHES, S.BWD_LAUNCHES)
    worst_f, worst_g, n = 0.0, 0.0, 0
    for scene_name in ("test", "scene1"):
        scene = (T.random_scene(5, 3, seed=4, bounds=(250.0, 120.0), device=dev)
                 if scene_name == "test" else T.create_scene1(device=dev))
        for cam_kind in ("ortho", "pinhole"):
            cam = (T.legacy_ortho_camera(device=dev) if cam_kind == "ortho"
                   else T.pinhole_camera(**SOFT_PINHOLE, device=dev))
            atol = 1e-3 if cam_kind == "ortho" else 2e-3
            for shading, shadows in SOFT_MODES:
                cfg = _soft_cfg(T, SOFT_W, SOFT_H, shading, shadows)
                label = f"[soft-parity] {scene_name} {cam_kind} {shading} shadows={shadows}"
                with torch.no_grad():
                    got = S.render_soft_tiled(scene, cam, cfg)
                    want = _twin_render(scene, cam, cfg)
                torch.cuda.synchronize()
                ferr = (got - want).abs().max().item()
                _require(bool(torch.isfinite(got).all()), f"{label}: non-finite")
                _require(ferr < FWD_BAR, f"{label}: fwd max err {ferr} >= {FWD_BAR}")
                gk = _leaf_grads(S.render_soft_tiled, scene, cam, cfg, _mean_sq)
                gt = _leaf_grads(_twin_render, scene, cam, cfg, _mean_sq)
                gerr = _compare_grads(label, gk, gt, atol)
                print(f"{label}: fwd max err {ferr:.5f} (bar {FWD_BAR}), leaf grads "
                      f"normalised max err {gerr:.2e} (bar {atol})")
                worst_f, worst_g, n = max(worst_f, ferr), max(worst_g, gerr), n + 1
    launched = (S.FWD_LAUNCHES - before[0], S.BWD_LAUNCHES - before[1])
    _require(launched[0] > 0 and launched[1] > 0, f"phase 7 launches {launched}")
    print(f"[soft-parity] {n} cases: fwd max err {worst_f:.5f}, grads {worst_g:.2e}; "
          f"{launched[0]} B4 and {launched[1]} B5 launches")

    # pixel-gradient probes: exact Jacobian rows d(pixel/255)/d(leaves)
    scene = T.create_scene1(device=dev)
    cam = T.legacy_ortho_camera(device=dev)
    cfg = _soft_cfg(T, SOFT_W, SOFT_H, "phong", True)
    renders = {"kernel": S.render_soft_tiled, "twin": _twin_render,
               "oracle": render_soft}
    with torch.no_grad():
        img = (S.render_soft_tiled(scene, cam, cfg)[..., :3] / 255.0).cpu().numpy()
    h_, w_ = SOFT_H, SOFT_W
    edge = (np.abs(np.diff(img, axis=0)).sum(-1)[:, : w_ - 1]
            + np.abs(np.diff(img, axis=1)).sum(-1)[: h_ - 1, :])
    flat = np.argsort(edge.ravel())[-8:]
    probes = [(int(q // (w_ - 1)), int(q % (w_ - 1))) for q in flat]
    rng = np.random.default_rng(7)
    probes += [(int(rng.integers(h_)), int(rng.integers(w_))) for _ in range(8)]
    err_twin = err_oracle = 0.0
    for pi, (yy, xx) in enumerate(probes):
        rows = {}
        for name, fn in renders.items():
            rows[name] = _leaf_grads(
                fn, scene, cam, cfg,
                lambda im, yy=yy, xx=xx, c=pi % 3: im[yy, xx, c] / 255.0)
        for k in rows["kernel"]:
            err_twin = max(err_twin, (rows["kernel"][k] - rows["twin"][k]).abs().max().item())
            err_oracle = max(err_oracle,
                             (rows["kernel"][k] - rows["oracle"][k]).abs().max().item())
    print(f"[soft-probes] 16 pixel-gradient rows, scene 1 phong+shadows "
          f"256x128: kernel vs twin max-abs {err_twin:.3e}, kernel vs "
          f"diff.render_soft {err_oracle:.3e} (bar 1e-4, 0..1 pixel units)")
    _require(err_twin <= 1e-4 and err_oracle <= 1e-4, "pixel-gradient probes over 1e-4")


def soft_phase_golden(T, dev, gdir):
    """Phase 8: the soft golden through the kernel (tests/test_golden.py)."""
    from opencl_ray_tracer_tpu_torch.kernels.soft import render_soft_pallas
    from opencl_ray_tracer_tpu_torch.utils import pack_rgba, read_png

    cfg = _soft_cfg(T, 160, 120, "phong", True)
    got = pack_rgba(render_soft_pallas(T.create_scene1(device=dev),
                                       T.legacy_ortho_camera(device=dev), cfg))
    want = read_png(os.path.join(gdir, "pallas_soft_scene1_phong.png"))
    same = float((got == want).all(axis=-1).mean())
    print(f"[golden] pallas_soft_scene1_phong: {same:.6f} identical (bar 0.999)")
    _require(same >= 0.999, f"soft golden below its bar: {same}")


def soft_phase_train(T, dev, smi):
    """Phase 9 (a): the bench's train step (bench.py:149-171, 619-629):
    headline scene, 1920x1080, phong + soft shadows, Adam lr 1e-3, a zero
    target, 10 steps through make_train_step, with step 1's gradients held
    against the twin's; then the stage times and a device trace."""
    import torch

    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
    from opencl_ray_tracer_tpu_torch.parallel import (
        adam,
        init_train_state,
        make_train_step,
    )
    from opencl_ray_tracer_tpu_torch.parallel.train import trainable_scene

    w, h = 1920, 1080
    scene = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
    cam = T.legacy_ortho_camera(device=dev)
    cfg = _soft_cfg(T, w, h, "phong", True)
    target = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
    inv_npix = 1.0 / (h * w * 3.0)

    def loss_fn(img):
        diff = (img[..., :3] - target[..., :3]) * (1.0 / 255.0)
        return torch.sum(diff * diff) * inv_npix

    # step 1's gradients: kernels vs twin, at the phase-7 bars
    gk = _leaf_grads(S.render_soft_tiled, scene, cam, cfg, loss_fn)
    gt = _leaf_grads(_twin_render, scene, cam, cfg, loss_fn)
    gerr = _compare_grads("[train] step-1 grads", gk, gt, 1e-3)
    with torch.no_grad():
        fimg = S.render_soft_tiled(scene, cam, cfg)
        ferr = (fimg - _twin_render(scene, cam, cfg)).abs().max().item()
    _require(ferr < FWD_BAR, f"[train] 1080p fwd max err {ferr}")
    print(f"[train] 1080p step-1: fwd max err {ferr:.5f} (bar {FWD_BAR}), leaf "
          f"grads normalised max err {gerr:.2e} (bar 1e-3); "
          f"{(fimg[..., :3] > 1.0).any(-1).float().mean().item():.4f} of pixels lit")

    step = make_train_step(cam, cfg)
    state = init_train_state(scene, adam(1e-3))
    o0 = state.scene.sphere_origin.detach().clone()
    S.FWD_LAUNCHES = S.BWD_LAUNCHES = 0
    losses = []
    for _ in range(10):
        state, loss = step(state, target)
        losses.append(float(loss))
    torch.cuda.synchronize()
    launches = (S.FWD_LAUNCHES, S.BWD_LAUNCHES)
    moved = (state.scene.sphere_origin.detach() - o0).abs().max().item()
    print(f"[train] 10 steps: loss {losses[0]:.6f} -> {losses[-1]:.6f}, sphere "
          f"origins moved {moved:.4e}; launches B4 {launches[0]}, B5 {launches[1]}")
    _require(all(map(lambda v: v == v and abs(v) != float("inf"), losses)),
             f"non-finite loss {losses}")
    _require(moved > 0.0, "the scene did not move")
    _require(launches[0] >= 10 and launches[1] >= 10,
             f"the train step did not go through both kernels: {launches}")

    # stage times, CUDA events, >= 20 runs each
    with torch.no_grad():
        params, taus, tables, counts, kc = S.soft_kernel_inputs(
            scene.pack(), cam, cfg)
    g = torch.full((h, w, 4), 1e-6, dtype=torch.float32, device=dev)
    leaves_in = [t.detach().requires_grad_(True) for t in (params, taus) + tuple(tables)]
    with torch.enable_grad():
        twin_out = S._soft_tiled_plain(leaves_in[0], leaves_in[1], leaves_in[2:],
                                       counts, cfg=kc)

    def twin_fwd():
        with torch.no_grad():
            S._soft_tiled_plain(params, taus, tables, counts, cfg=kc)

    def twin_fwd_bwd():
        with torch.enable_grad():
            lv = [t.detach().requires_grad_(True) for t in (params, taus) + tuple(tables)]
            out = S._soft_tiled_plain(lv[0], lv[1], lv[2:], counts, cfg=kc)
            torch.autograd.grad(out, lv, g, allow_unused=True)

    def twin_bwd():
        torch.autograd.grad(twin_out, leaves_in, g, allow_unused=True,
                            retain_graph=True)

    def whole_fwd_bwd():
        s = trainable_scene(scene)
        loss_fn(S.render_soft_tiled(s, cam, cfg)).backward()

    def b4():
        S.soft_tiled_fwd(params, taus, tables, counts, cfg=kc)

    def b5():
        S.soft_tiled_bwd(params, taus, tables, counts, g, cfg=kc)

    fns = {
        "B4 alone": b4,
        "B5 alone": b5,
        "twin forward": twin_fwd,
        "twin backward": twin_bwd,
        "twin forward + backward": twin_fwd_bwd,
        "whole fwd+bwd (render_soft_tiled + backward)": whole_fwd_bwd,
        "whole train step": lambda: step(state, target),
    }
    times = {what: _time_ms(fn, 20, 2) for what, fn in fns.items()}
    for what, (med, lo, hi) in times.items():
        print(f"[time] train 1080p phong+shadows: {what} median {med:.4f} ms "
              f"[{lo:.4f}, {hi:.4f}] over 20 runs; {smi}")
    # a call above also holds the wrapper's host work (checks, allocation,
    # the ctypes call); back to back, the launches overlap it
    for what, fn in (("B4", b4), ("B5", b5)):
        print(f"[time] train 1080p phong+shadows: {what} back to back "
              f"{_back_to_back_ms(fn, 100):.4f} ms per launch over 100; {smi}")
    _train_stages(S, state, cam, cfg, loss_fn, smi)
    kernels, busy, dev_ms, top = _device_profile(lambda: step(state, target), 10)
    print(f"[stages] train step 1080p: {kernels:.1f} device kernels per step, "
          f"device busy {busy:.4f} of the wall time ({dev_ms:.4f} ms of device "
          f"work per step), 10 traced steps; {smi}")
    print("[stages] train step 1080p, device ms per step by kernel: "
          + "; ".join(f"{name} {ms:.4f}" for name, ms in top))

    src = "opencl_ray_tracer_tpu_torch/kernels/csrc/soft_tiled.cu"
    shape = "train step 1920x1080 10sph+1cube phong+soft shadows"
    return [
        {"name": "soft_tiled_fwd", "route": "cuda", "source": src,
         "replaces": "opencl_ray_tracer_tpu/kernels/soft_tiled.py:1397",
         "launches": launches[0], "max_abs_err": ferr,
         "tolerance": f"every pixel within {FWD_BAR}/255 of the twin",
         "shape": shape, "ms": times["B4 alone"][0],
         "plain_ms": times["twin forward"][0]},
        {"name": "soft_tiled_bwd", "route": "cuda", "source": src,
         "replaces": "opencl_ray_tracer_tpu/kernels/soft_tiled.py:1580",
         "launches": launches[1], "max_abs_err": gerr,
         "tolerance": "every scene-leaf gradient within 1e-3 of the twin's, "
                      "normalised by the twin's largest (max_abs_err is that "
                      "normalised error)",
         "shape": shape, "ms": times["B5 alone"][0],
         "plain_ms": times["twin backward"][0]},
    ]


def _train_stages(S, state, cam, cfg, loss_fn, smi):
    """The train step's stages (what make_train_step's step runs) back to
    back with a CUDA event between each, so per step they add up to the
    whole: 23 steps, the first 3 a warm-up."""
    import torch

    from opencl_ray_tracer_tpu_torch.parallel import scene_leaves

    stages = ("pack", "soft_bins_for_config", "tables + params",
              "forward (B4)", "loss", "backward (B5 + gather)", "adam")
    per = {name: [] for name in stages + ("step",)}
    leaves = scene_leaves(state.scene)
    for i in range(23):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        ev[0].record()
        packed = state.scene.pack()
        ev[1].record()
        bins = S.soft_bins_for_config(packed, cam, cfg)
        ev[2].record()
        params, taus, tables, counts, kc = S.soft_kernel_inputs(packed, cam, cfg, bins)
        ev[3].record()
        img = S.SoftTiledFunction.apply(params, taus, *tables, counts, kc)
        ev[4].record()
        loss = loss_fn(img)
        ev[5].record()
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        ev[6].record()
        for p, g in zip(leaves.values(), grads):
            p.grad = torch.zeros_like(p) if g is None else g
        state.opt_state.step()
        ev[7].record()
        ev[7].synchronize()
        if i < 3:
            continue
        for j, name in enumerate(stages):
            per[name].append(ev[j].elapsed_time(ev[j + 1]))
        per["step"].append(ev[0].elapsed_time(ev[-1]))
    parts = "; ".join(f"{name} mean {statistics.fmean(v):.4f} median "
                      f"{statistics.median(v):.4f}" for name, v in per.items())
    print(f"[stages] train step 1080p, ms over 20 steps: {parts}; {smi}")


def soft_phase_cli_fit():
    """Phase 9 (b): the CLI's fit on the card at 640x480 (lambert, no
    shadows: the per-primitive shading mode) must lower the loss and the
    largest sphere-origin error."""
    import re

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "opencl_ray_tracer_tpu_torch.cli", "fit",
         "--scene", "1", "--steps", "60"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": root},
    )
    print(proc.stdout.strip())
    _require(proc.returncode == 0, f"cli fit failed:\n{proc.stderr[-4000:]}")
    err = re.search(r"max origin error ([0-9.]+) -> ([0-9.]+)", proc.stdout)
    loss = re.search(r"loss: ([0-9.]+) -> ([0-9.]+)", proc.stdout)
    _require(err and loss, "cli fit printed no result")
    e0, e1 = float(err.group(1)), float(err.group(2))
    l0, l1 = float(loss.group(1)), float(loss.group(2))
    print(f"[fit] cli fit --scene 1 --steps 60: loss {l0} -> {l1}, max origin "
          f"error {e0} -> {e1}; {time.perf_counter() - t0:.1f} s with start-up")
    _require(l1 < l0 and e1 < e0, "cli fit did not lower the loss and the error")


if __name__ == "__main__":
    sys.exit(main())
