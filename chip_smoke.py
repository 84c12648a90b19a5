#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path — the tiled hard forward frame — through the
entry points a user calls, and fails (non-zero exit, no result line) unless
every phase passes:

1. device: torch, CUDA and nvcc versions, the card's name and power limit;
2. build: nvcc builds kernels/csrc/fwd_tiled.cu from this checkout;
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
   per frame and the device's busy share.

Kernel vs twin is bounded on every pixel: float frames within 0.5/255,
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
    (the union of kernel intervals), and device ms per call, from a
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
    return len(spans) / n, busy / wall_us, busy / n / 1e3


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
    print("[golden] pallas_soft_scene1_phong: skipped, the soft kernels are "
          "not ported yet (ROADMAP B4)")

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
        launches, busy, dev_ms = _device_profile(
            lambda: fwd_tiled.render_tiled(scene, ortho, cfg), 20)
        print(f"[stages] {label}: {launches:.1f} device kernels per frame, "
              f"device busy {busy:.4f} of the wall time ({dev_ms:.4f} ms of "
              f"device work per frame), 20 traced frames; {smi}")

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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
