"""Benchmark of the port on one NVIDIA card. Prints ONE JSON line on stdout:

  {"metric": ..., "value": N, "unit": "rays/s", "rows": {...}, ...}

    python -m opencl_ray_tracer_tpu_torch.bench [--skip-context]
    python -m opencl_ray_tracer_tpu_torch.bench --scene 1 --shading phong

Headline: primary rays/s at 1080p, forward, on the 10 spheres + 1 cube
scene (phong + hard shadows) through the tiled CUDA kernel emitting the
packed int32 framebuffer, with scene-static bins (the frame is the
coefficient gather plus the kernel). Further rows, in the JAX bench's
order: the dynamic frame (the headline frame through a pinhole camera,
re-binned inside every call), the soft differentiable forward + backward
with every gradient leaf consumed, and (unless --skip-context) the tiled
legacy frame under both cameras, the brute kernel's legacy frame, the
100 + 100 stress frame at cull_k=96, soft forward + backward on 50 spheres
+ 4 cubes and on the stress scene (cull_k=96, shadow_cull_k=136), 4K
legacy with 100 + 100 primitives, and the headline scene's phong and soft
frames through the pinhole camera; then the train step, the JAX bench's two
mesh rows and parity scalars of scene 1 (tiled vs the oracle, soft
gradients vs the torch-autograd oracle, pixel-gradient rows). The mesh
rows: `shard_map_overhead`, the headline frame through `render_sharded` on
a one-rank mesh against `render_tiled`, both re-binned in the call; and
(unless --skip-scaling) the sharded train step at a fixed 256x256 frame
over n = 1, 2, 4, 8 gloo ranks on the CPU (`sharding_eff_*`: t(1) / t(n)
at fixed work and fixed cores, a check of the sharding structure, not of a
card). `--scaling-worker N` runs that step over N ranks and prints one
JSON line.

Every row is the median and [min, max] of per-call CUDA-event times
(bench_util.call_times_ms): the host's work inside a call counts. Beside
them: `device_ms` (bench_util.device_ms: the calls queued behind a spin on
the card; a call that waits for the card inside, as every tiled call does
on its bins' overflow flag, reads its host's time there too),
`device_busy_ms` (the union of the call's kernel intervals in a
torch.profiler trace: the card's own time, whatever the host does), and
for a tiled row the K caps of its final bins (`k`, `shadow_k`: the port
re-bins with both caps doubled where a list overflows). The headline, the
1080p fwd+bwd and the stress rows also carry their speed of light: the H100
bound of the row's inputs (utils/profiling.py; B1's for a hard frame, B4's
plus B5's on the loss's own cotangent for a soft step) over `device_ms`.
The headline, dynamic, fwd+bwd and train-step rows also carry
`device_graph_us`: the JAX bench's own measurement
(bench_util.device_frame_time_us / device_step_time_us), N frames or steps
captured as one CUDA graph at the config's K caps (runtime/graph.py), each
with its own camera origin, timed at two frame counts and taken as the
slope: microseconds a frame or step with no Python in it (JSON keys
`headline_graph_us`, `dynamic_graph_us`, `fwd_bwd_graph_us`,
`train_graph_us`). Rows go to stderr, the JSON line to stdout. Runs on the
card only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from opencl_ray_tracer_tpu_torch.bench_util import (
    call_times_ms,
    device_frame_time_us,
    device_ms,
    device_step_time_us,
    median_spread,
)

W, H = 1920, 1080
W4K, H4K = 3840, 2160

HEADLINE = "headline tiled phong+shadows 1080p 10sph+1cube (packed fb)"
DYNAMIC = "DYNAMIC frame phong+shadows 1080p pinhole (re-binned every call)"
FWD_BWD = "fwd+bwd soft phong+shadows 1080p 10sph+1cube"
TILED_LEGACY = "tiled legacy 1080p 10sph+1cube (packed fb)"
TILED_PINHOLE = "tiled legacy 1080p pinhole (projective culling)"
BRUTE_LEGACY = "brute legacy 1080p 10sph+1cube"
STRESS = "tiled legacy 1080p 100sph+100cubes (1200 tris, k=96)"
SOFT_50_4 = "fwd+bwd soft phong+shadows 1080p 50sph+4cubes"
STRESS_SOFT = "fwd+bwd soft phong+shadows 1080p 100sph+100cubes (k=96)"
FOUR_K = "tiled legacy 4K 100sph+100cubes (1200 tris, k=96, packed)"
PINHOLE_PHONG = "tiled phong+shadows 1080p pinhole"
PINHOLE_SOFT = "fwd+bwd soft phong+shadows 1080p pinhole"
TRAIN = "train step (adam) soft phong+shadows 1080p"

SCALE_SIZE = 256               # the scaling row's fixed frame, SCALE_SIZE^2
SCALE_RANKS = (1, 2, 4, 8)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="opencl_ray_tracer_tpu_torch.bench",
        description="benchmark the port on one NVIDIA card")
    ap.add_argument("--scene", type=int, default=None, choices=[1, 2, 3],
                    help="bench a library scene instead of the default rows")
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--shading", default="phong",
                    choices=["legacy", "lambert", "phong"])
    ap.add_argument("--no-shadows", action="store_true")
    ap.add_argument("--cull-k", type=int, default=None)
    ap.add_argument("--skip-context", action="store_true",
                    help="headline, dynamic, fwd+bwd, train-step, mesh and "
                         "parity rows only")
    ap.add_argument("--skip-scaling", action="store_true",
                    help="no CPU sharding-efficiency row")
    ap.add_argument("--scaling-worker", type=int, default=None, metavar="N",
                    help="only the sharded train step over N gloo CPU ranks: "
                         "one JSON line")
    ap.add_argument("--scaling-size", type=int, default=SCALE_SIZE,
                    help="the scaling row's square frame (its height must "
                         "split over 8 ranks)")
    return ap.parse_args(argv)


def row_plan(args) -> list:
    """Labels of the timed rows this invocation runs, in order."""
    if args.scene is not None:
        return [f"scene{args.scene} {args.shading} {args.width}x{args.height}"]
    rows = [HEADLINE, DYNAMIC, FWD_BWD]
    if not args.skip_context:
        rows += [TILED_LEGACY, TILED_PINHOLE, BRUTE_LEGACY, STRESS, SOFT_50_4,
                 STRESS_SOFT, FOUR_K, PINHOLE_PHONG, PINHOLE_SOFT]
    return rows + [TRAIN]


def _row(rows, label, fn, n, n_pix, **extra):
    """Time fn (per call: n calls, CUDA events; device_ms: min(n, 20) calls
    behind a spin; device_busy_ms: 5 traced calls) into rows[label]."""
    from opencl_ray_tracer_tpu_torch.utils.profiling import (
        device_profile,
        rays_per_second,
    )

    ms, lo, hi = median_spread(call_times_ms(fn, n))
    kernels, _, busy_ms, _ = device_profile(fn, 5)
    rows[label] = {"ms": ms, "ms_min": lo, "ms_max": hi,
                   "rays_per_s": rays_per_second(n_pix, ms),
                   "device_ms": device_ms(fn, min(n, 20)),
                   "device_busy_ms": busy_ms, "device_kernels": kernels, **extra}
    r = rows[label]
    caps = f", k={r['k']} shadow_k={r['shadow_k']}" if "k" in r else ""
    print(f"# {label}: {ms:.4f} ms [{lo:.4f}, {hi:.4f}] -> "
          f"{r['rays_per_s']:.3e} rays/s over {n} calls; device {r['device_ms']:.4f} "
          f"ms behind a spin, busy {busy_ms:.4f} ms ({kernels:.0f} kernels) a "
          f"call{caps}", file=sys.stderr)
    return r


def _caps(bins) -> dict:
    """The K caps a tiled row's final bins ran at."""
    return {"k": max(bins.k_tri, bins.k_sph),
            "shadow_k": max(bins.k_sh_tri, bins.k_sh_sph)}


def bench_tiled(scene, config, cam, dynamic=False):
    """(the tiled frame's call, its final bins). Scene-static bins, made once
    (as a fixed scene under a fixed camera would keep them), unless
    `dynamic`: then `bin_for_config` runs inside every call, as for a moving
    camera or an edited scene, with its check of the lists' overflow."""
    from opencl_ray_tracer_tpu_torch.kernels.fwd_tiled import (
        bin_for_config,
        render_tiled_packed,
    )

    packed = scene.pack()
    bins = bin_for_config(packed, cam, config)
    if dynamic:
        return (lambda: render_tiled_packed(packed, cam, config)), bins
    return (lambda: render_tiled_packed(packed, cam, config, bins=bins)), bins


def tiled_bound(scene, config, cam, bins):
    """(bound_ms, bound_by) of B1 on the frame's inputs."""
    from opencl_ray_tracer_tpu_torch.kernels.fwd_tiled import kernel_inputs
    from opencl_ray_tracer_tpu_torch.utils.profiling import b1_bound

    args, kw = kernel_inputs(
        scene.pack(), cam, bins, height=config.height, width=config.width,
        shading=config.shading, shadows=config.shadows,
        out_format=config.framebuffer_dtype)
    return b1_bound(args, kw)[:2]


def bench_brute(scene, config, cam):
    from opencl_ray_tracer_tpu_torch.kernels import render_pallas_packed

    packed = scene.pack()
    return lambda: render_pallas_packed(packed, cam, config)


def bench_fwd_bwd_soft(scene, config, cam):
    """(the soft step's call, its final bins): forward + backward through
    the tiled soft kernels, gradients for every scene leaf, each of them
    consumed."""
    import torch

    from opencl_ray_tracer_tpu_torch.kernels.soft import render_soft_pallas
    from opencl_ray_tracer_tpu_torch.kernels.soft_tiled import soft_bins_for_config
    from opencl_ray_tracer_tpu_torch.parallel.train import (
        scene_leaves,
        trainable_scene,
    )

    s = trainable_scene(scene)
    leaves = list(scene_leaves(s).values())

    def step():
        img = render_soft_pallas(s, cam, config)
        loss = torch.mean(img[..., :3] ** 2)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss + sum(g.sum() for g in grads if g is not None)

    return step, soft_bins_for_config(scene.pack(), cam, config)


def fwd_bwd_bound(scene, config, cam):
    """(bound_ms, bound_by) of the soft step: B4's bound plus B5's on the
    cotangent of the step's loss, mean(img[..., :3] ** 2)."""
    import torch

    from opencl_ray_tracer_tpu_torch.kernels.soft_tiled import (
        soft_kernel_inputs,
        soft_tiled_fwd,
    )
    from opencl_ray_tracer_tpu_torch.utils.profiling import tiled_soft_bounds

    with torch.no_grad():
        operands = soft_kernel_inputs(scene.pack(), cam, config)
        img = soft_tiled_fwd(*operands[:4], cfg=operands[4])
    g = torch.zeros_like(img)
    g[..., :3] = 2.0 * img[..., :3] / (config.height * config.width * 3)
    b4, b5 = tiled_soft_bounds(scene, cam, config, operands, g)[:2]
    return b4[0] + b5[0], f"{b4[1]}+{b5[1]}"


def _sol(row, bound_ms, bound_by, bwd=False):
    """Speed of light of a row over its device_ms: sol_fraction, sol_bound
    (what bounds it) and sol_bound_ms, or for a soft step sol_fraction_bwd,
    sol_bwd_bound and sol_bwd_bound_ms."""
    from opencl_ray_tracer_tpu_torch.utils.profiling import sol_fraction

    sol = sol_fraction(row["device_ms"], bound_ms, bound_by)
    frac, key = ("sol_fraction_bwd", "sol_bwd_bound") if bwd else (
        "sol_fraction", "sol_bound")
    row.update({frac: sol["achieved_fraction"], key: sol["bound"],
                f"{key}_ms": bound_ms})
    print(f"#   speed of light: bound {bound_ms:.5f} ms by {bound_by}, "
          f"achieved {sol['achieved_fraction']:.4e} of it over device_ms "
          f"({bound_ms / row['device_busy_ms']:.4e} over device_busy_ms)",
          file=sys.stderr)


def _graph_row(row, label, us, n):
    """`device_graph_us` of a row, printed."""
    row["device_graph_us"] = us
    print(f"#   {label}: {us:.2f} us a frame or step in one CUDA graph "
          f"(the JAX bench's two-point slope over {n} frames)", file=sys.stderr)
    return us


def graph_frame_us(scene, config, cam, bins=None, n_frames=100):
    """device_frame_time_us of the tiled frame at fixed K: through the given
    (scene-static) bins, or re-binned in every frame (the dynamic row)."""
    from opencl_ray_tracer_tpu_torch.kernels.fwd_tiled import (
        _render_tiled_jit,
        render_tiled_fixed,
    )

    packed = scene.pack()
    if bins is None:
        fn = lambda c: render_tiled_fixed(packed, c, config)  # noqa: E731
    else:
        fn = lambda c: _render_tiled_jit(  # noqa: E731
            packed, c, bins, height=config.height, width=config.width,
            shading=config.shading, shadows=config.shadows,
            out_format=config.framebuffer_dtype)
    return device_frame_time_us(fn, cam, n_frames=n_frames)


def graph_fwd_bwd_us(scene, config, cam, n_frames=20):
    """device_step_time_us of the soft step at fixed K (`_soft_tiled_core`),
    every leaf's gradient consumed into the scalar."""
    import torch

    from opencl_ray_tracer_tpu_torch.kernels.soft_tiled import _soft_tiled_core
    from opencl_ray_tracer_tpu_torch.parallel.train import (
        scene_leaves,
        step_taus,
        trainable_scene,
    )

    s = trainable_scene(scene)
    leaves = list(scene_leaves(s).values())
    taus = step_taus(config, cam.o0.device)

    def step(c):
        img = _soft_tiled_core(s.pack(), c, *taus, config.height, config.width,
                               config.shading, config.shadows, config.cull_k,
                               config.shadow_cull_k)
        loss = torch.mean(img[..., :3] ** 2)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss + sum(g.sum() for g in grads if g is not None)

    return device_step_time_us(step, cam, n_frames=n_frames)


def graph_train_us(scene, config, cam, n_steps=10):
    """device_step_time_us of the train step at fixed K
    (`parallel.train.fixed_k_step`, Adam on the card), its loss the scalar."""
    import torch

    from opencl_ray_tracer_tpu_torch.parallel.train import (
        adam,
        fixed_k_step,
        init_train_state,
        step_taus,
    )

    dev = cam.o0.device
    state = init_train_state(scene, adam(1e-3))
    target = torch.zeros((config.height, config.width, 4), dtype=torch.float32,
                         device=dev)
    taus = step_taus(config, dev)
    return device_step_time_us(
        lambda c: fixed_k_step(state, target, c, config, taus), cam,
        n_frames=n_steps)


def bench_train_step(scene, config, cam):
    import torch

    from opencl_ray_tracer_tpu_torch.parallel import (
        adam,
        init_train_state,
        make_train_step,
    )

    optimizer = adam(1e-3)
    step = make_train_step(cam, config, optimizer)
    state = init_train_state(scene, optimizer)
    target = torch.zeros((config.height, config.width, 4), dtype=torch.float32,
                         device=scene.sphere_origin.device)
    return lambda: step(state, target)


def bench_sharded_overhead(scene, config, cam, n=20):
    """(sharded ms, unsharded ms): `render_sharded` of the frame on a
    one-rank mesh against `render_tiled`, both binning inside the call (the
    sharded path bins its block in the call too); per call the median of n
    CUDA-event times, best of 3 runs each. The one-card stand-in for the
    sharded forward: several cards are not measured."""
    from opencl_ray_tracer_tpu_torch.kernels.fwd_tiled import render_tiled
    from opencl_ray_tracer_tpu_torch.parallel import make_mesh, render_sharded

    mesh = make_mesh(1)
    best = lambda fn: min(median_spread(call_times_ms(fn, n))[0]  # noqa: E731
                          for _ in range(3))
    return (best(lambda: render_sharded(scene, cam, config, mesh=mesh)),
            best(lambda: render_tiled(scene, cam, config)))


def _scaling_rank(n: int, size: int) -> None:
    """One gloo rank of the scaling row: the sharded train step (lambert,
    soft, backend "xla": the torch-autograd oracle) at a fixed size x size
    frame over n ranks, each with 1/n of torch's threads (OMP_NUM_THREADS
    where set, else the cores: fixed work, fixed cores, ideal t(n) ==
    t(1)). Rank 0 prints one JSON line: the median and spread of 5 runs of
    10 steps, microseconds a step."""
    import torch

    from opencl_ray_tracer_tpu_torch import RenderConfig, create_scene, legacy_ortho_camera
    from opencl_ray_tracer_tpu_torch.parallel import (
        adam,
        distributed,
        init_train_state,
        make_mesh,
        make_train_step,
        replicate,
        shard_rows,
    )

    torch.set_num_threads(max(1, torch.get_num_threads() // n))
    distributed.initialize(backend="gloo")
    try:
        cpu = torch.device("cpu")
        config = RenderConfig(width=size, height=size, shading="lambert",
                              soft=True, framebuffer_dtype="float", backend="xla")
        mesh = make_mesh(n)
        optimizer = adam(1e-3)
        step = make_train_step(legacy_ortho_camera(device=cpu), config, optimizer,
                               mesh=mesh)
        target = shard_rows(torch.zeros((size, size, 4)), mesh)
        state = init_train_state(replicate(create_scene(1, device=cpu), mesh),
                                 optimizer)
        state, _ = step(state, target)  # warm
        n_steps, samples = 10, []
        for _ in range(5):
            t0 = time.perf_counter_ns()
            for _ in range(n_steps):
                state, loss = step(state, target)
            samples.append((time.perf_counter_ns() - t0) / 1e3 / n_steps)
        us, lo, hi = median_spread(samples)
        if mesh.rank == 0:
            print(json.dumps({"n": n, "size": size, "us_per_step": us,
                              "us_min": lo, "us_max": hi, "loss": float(loss)}))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def scaling_worker(n: int, size: int = SCALE_SIZE) -> dict:
    """The scaling row at n ranks: n gloo CPU processes of
    `--scaling-worker n` started here; rank 0's JSON line."""
    from opencl_ray_tracer_tpu_torch.parallel import distributed

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {"PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    procs = distributed.launch_local(
        n, [sys.executable, "-m", "opencl_ray_tracer_tpu_torch.bench",
            "--scaling-worker", str(n), "--scaling-size", str(size)], 1200, env)
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"scaling rank {r} of {n} failed:\n{p.stderr[-2000:]}")
    return json.loads(procs[0].stdout.strip().splitlines()[-1])


def bench_weak_scaling(size: int = SCALE_SIZE) -> dict:
    """{n: the scaling row at n ranks} for n = 1, 2, 4, 8."""
    return {n: scaling_worker(n, size) for n in SCALE_RANKS}


def mesh_keys(sharded_ms: float, unsharded_ms: float, scaling=None) -> dict:
    """The JSON keys of the mesh rows, under the JAX bench's names:
    shard_map_overhead (sharded / unsharded - 1); with the scaling row,
    sharding_eff_8dev_fixed_work = t(1) / t(n max), its range from the
    spreads, and sharding_eff_semantics."""
    out = {"shard_map_overhead": sharded_ms / unsharded_ms - 1.0,
           "sharded_fwd_ms": sharded_ms, "unsharded_fwd_ms": unsharded_ms}
    if scaling:
        one, top = scaling[1], scaling[max(scaling)]
        out.update({
            "sharding_eff_8dev_fixed_work": one["us_per_step"] / top["us_per_step"],
            "sharding_eff_range": [one["us_min"] / top["us_max"],
                                   one["us_max"] / top["us_min"]],
            "sharding_eff_semantics": "cpu-mesh-structure-check",
        })
    return out


def bench_mesh_rows(args, scene, config, cam) -> dict:
    """The two mesh rows (the scaling row unless --skip-scaling), printed
    and as their JSON keys."""
    sh, un = bench_sharded_overhead(scene, config, cam)
    print(f"# sharded fwd (one-rank mesh): {sh:.4f} ms a frame against "
          f"{un:.4f} unsharded, both binning in the call (overhead "
          f"{100.0 * (sh / un - 1.0):+.1f}%)", file=sys.stderr)
    scaling = None if args.skip_scaling else bench_weak_scaling(args.scaling_size)
    for n, r in sorted((scaling or {}).items()):
        print(f"# sharding efficiency (gloo CPU ranks, fixed {r['size']}x"
              f"{r['size']}): n={n} {r['us_per_step']:.0f} us/step "
              f"[{r['us_min']:.0f}, {r['us_max']:.0f}] efficiency "
              f"{scaling[1]['us_per_step'] / r['us_per_step']:.3f}", file=sys.stderr)
    return mesh_keys(sh, un, scaling)


def bench_parity(device) -> dict:
    """Parity scalars of scene 1 on the card: the tiled kernel vs the
    oracle (legacy identical, phong within 0.5/255), the soft kernels'
    gradients vs the torch-autograd oracle `diff.render_soft` for
    mean(img^2), and 16 exact pixel-gradient rows in 0..1 pixel units."""
    import numpy as np
    import torch

    from opencl_ray_tracer_tpu_torch import (
        RenderConfig,
        create_scene,
        legacy_ortho_camera,
    )
    from opencl_ray_tracer_tpu_torch.diff import render_soft
    from opencl_ray_tracer_tpu_torch.kernels.fwd_tiled import render_tiled
    from opencl_ray_tracer_tpu_torch.kernels.soft import render_soft_pallas
    from opencl_ray_tracer_tpu_torch.parallel.train import (
        scene_leaves,
        trainable_scene,
    )
    from opencl_ray_tracer_tpu_torch.ref.tracer import _render_oracle

    cam = legacy_ortho_camera(device=device)
    scene = create_scene(1, seed=0, device=device)
    out = {}
    cfg_i = RenderConfig(width=640, height=480, shading="legacy")
    a, b = render_tiled(scene, cam, cfg_i), _render_oracle(scene, cam, cfg_i)
    out["parity_legacy_frac_identical"] = (a == b).all(-1).float().mean().item()
    cfg_f = RenderConfig(width=640, height=480, shading="phong", shadows=True,
                         framebuffer_dtype="float")
    af, bf = render_tiled(scene, cam, cfg_f), _render_oracle(scene, cam, cfg_f)
    out["parity_phong_frac_close"] = (
        (af - bf).abs().amax(-1) < 0.5).float().mean().item()

    cfg_s = RenderConfig(width=256, height=128, shading="phong", shadows=True,
                         soft=True, framebuffer_dtype="float", tau_depth=1.0,
                         tau_edge=0.5)

    def grads(render, fn):
        s = trainable_scene(scene)
        leaves = list(scene_leaves(s).values())
        g = torch.autograd.grad(fn(render(s, cam, cfg_s)), leaves,
                                allow_unused=True)
        return [torch.zeros_like(v) if x is None else x
                for v, x in zip(leaves, g)]

    mean_sq = lambda img: torch.mean(img[..., :3] ** 2)  # noqa: E731
    gp, gj = grads(render_soft_pallas, mean_sq), grads(render_soft, mean_sq)
    gerr = max((p - j).abs().max().item() for p, j in zip(gp, gj) if p.numel())
    gscale = max(j.abs().max().item() for j in gj if j.numel())
    out["parity_soft_grad_max_err"] = gerr
    out["parity_soft_grad_rel_err"] = gerr / (gscale + 1e-20)

    # probes: the 8 strongest-edge pixels + 8 spread over the image, the
    # probed channel cycling so every albedo chain is checked
    h_, w_ = cfg_s.height, cfg_s.width
    with torch.no_grad():
        img = (render_soft_pallas(scene, cam, cfg_s)[..., :3] / 255.0).cpu().numpy()
    edge = (np.abs(np.diff(img, axis=0)).sum(-1)[:, : w_ - 1]
            + np.abs(np.diff(img, axis=1)).sum(-1)[: h_ - 1, :])
    flat = np.argsort(edge.ravel())[-8:]
    probes = [(int(q // (w_ - 1)), int(q % (w_ - 1))) for q in flat]
    rng = np.random.default_rng(7)
    probes += [(int(rng.integers(h_)), int(rng.integers(w_))) for _ in range(8)]
    perr = 0.0
    for pi, (yy, xx) in enumerate(probes):
        pixel = lambda im, yy=yy, xx=xx, c=pi % 3: im[yy, xx, c] / 255.0  # noqa: E731
        rp, rj = grads(render_soft_pallas, pixel), grads(render_soft, pixel)
        perr = max([perr] + [(p - j).abs().max().item()
                             for p, j in zip(rp, rj) if p.numel()])
    out["parity_pixel_grad_max_err"] = perr
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.scaling_worker is not None:  # CPU ranks, asked for explicitly
        if "WORLD_SIZE" in os.environ:
            _scaling_rank(args.scaling_worker, args.scaling_size)
        else:
            print(json.dumps(scaling_worker(args.scaling_worker, args.scaling_size)))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the bench runs on the card")
    from opencl_ray_tracer_tpu_torch import (
        RenderConfig,
        create_scene,
        legacy_ortho_camera,
        pinhole_camera,
        random_scene,
    )
    from opencl_ray_tracer_tpu_torch.utils.profiling import (
        device_kind,
        rays_per_second,
    )

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"# device: {smi}", file=sys.stderr)
    wid, hgt = args.width, args.height
    n_pix = wid * hgt
    cam = legacy_ortho_camera(device=device)
    rows = {}
    plan = row_plan(args)

    if args.scene is not None:
        scene = create_scene(args.scene, seed=0, device=device)
        cfg = RenderConfig(
            width=wid, height=hgt, shading=args.shading,
            shadows=not args.no_shadows,
            framebuffer_dtype="int" if args.shading == "legacy" else "float",
            **({"cull_k": args.cull_k} if args.cull_k else {}),
        )
        fn, bins = bench_tiled(scene, cfg, cam)
        r = _row(rows, plan[0], fn, 100, n_pix, **_caps(bins))
        print(json.dumps({
            "metric": f"rays_per_s_scene{args.scene}_{args.shading}_{wid}x{hgt}",
            "value": r["rays_per_s"], "unit": "rays/s", "rows": rows,
            "device": smi,
        }))
        return 0

    bounds = (float(wid) - 10, float(hgt) - 10)
    scene_hl = random_scene(10, 1, seed=0, bounds=bounds, device=device)
    cfg_hl = RenderConfig(width=wid, height=hgt, shading="phong", shadows=True,
                          framebuffer_dtype="packed")
    fn, bins = bench_tiled(scene_hl, cfg_hl, cam)
    head = _row(rows, HEADLINE, fn, 100, n_pix, **_caps(bins))
    _sol(head, *tiled_bound(scene_hl, cfg_hl, cam, bins))
    _graph_row(head, HEADLINE, graph_frame_us(scene_hl, cfg_hl, cam, bins), 100)

    cam_ph = pinhole_camera(
        position=(wid / 2.0, hgt / 2.0, 900.0),
        look_at=(wid / 2.0, hgt / 2.0, -85.0),
        fov_degrees=60.0, width=wid, height=hgt, device=device)
    fn, bins = bench_tiled(scene_hl, cfg_hl, cam_ph, dynamic=True)
    dyn = _row(rows, DYNAMIC, fn, 50, n_pix, **_caps(bins))
    _graph_row(dyn, DYNAMIC, graph_frame_us(scene_hl, cfg_hl, cam_ph, n_frames=50),
               50)

    cfg_soft = RenderConfig(width=wid, height=hgt, shading="phong", shadows=True,
                            soft=True, framebuffer_dtype="float", tau_depth=1.0,
                            tau_edge=0.5)
    fn, bins = bench_fwd_bwd_soft(scene_hl, cfg_soft, cam)
    fb = _row(rows, FWD_BWD, fn, 20, n_pix, **_caps(bins))
    _sol(fb, *fwd_bwd_bound(scene_hl, cfg_soft, cam), bwd=True)
    _graph_row(fb, FWD_BWD, graph_fwd_bwd_us(scene_hl, cfg_soft, cam), 20)

    stress = None
    if not args.skip_context:
        cfg_legacy = RenderConfig(width=wid, height=hgt, shading="legacy",
                                  framebuffer_dtype="packed")
        fn, bins = bench_tiled(scene_hl, cfg_legacy, cam)
        _row(rows, TILED_LEGACY, fn, 100, n_pix, **_caps(bins))
        fn, bins = bench_tiled(scene_hl, cfg_legacy, cam_ph)
        _row(rows, TILED_PINHOLE, fn, 100, n_pix, **_caps(bins))
        # the brute kernel has no packed-word output: its own int framebuffer
        _row(rows, BRUTE_LEGACY,
             bench_brute(scene_hl, cfg_legacy.replace(framebuffer_dtype="int"),
                         cam), 30, n_pix)
        scene_stress = random_scene(100, 100, seed=0, bounds=bounds, device=device)
        cfg_stress = cfg_legacy.replace(cull_k=96)
        fn, bins = bench_tiled(scene_stress, cfg_stress, cam)
        r = _row(rows, STRESS, fn, 30, n_pix, **_caps(bins))
        _sol(r, *tiled_bound(scene_stress, cfg_stress, cam, bins))
        scene_100 = random_scene(50, 4, seed=1, bounds=bounds, device=device)
        fn, bins = bench_fwd_bwd_soft(scene_100, cfg_soft, cam)
        _row(rows, SOFT_50_4, fn, 10, n_pix, **_caps(bins))
        cfg_stress_soft = cfg_soft.replace(cull_k=96, shadow_cull_k=136)
        fn, bins = bench_fwd_bwd_soft(scene_stress, cfg_stress_soft, cam)
        stress = _row(rows, STRESS_SOFT, fn, 10, n_pix, **_caps(bins))
        _sol(stress, *fwd_bwd_bound(scene_stress, cfg_stress_soft, cam),
             bwd=True)
        scene_4k = random_scene(100, 100, seed=2,
                                bounds=(float(W4K) - 10, float(H4K) - 10),
                                device=device)
        cfg_4k = RenderConfig(width=W4K, height=H4K, shading="legacy", cull_k=96,
                              framebuffer_dtype="packed")
        fn, bins = bench_tiled(scene_4k, cfg_4k, cam)
        _row(rows, FOUR_K, fn, 20, W4K * H4K, **_caps(bins))
        fn, bins = bench_tiled(scene_hl, cfg_hl, cam_ph)
        _row(rows, PINHOLE_PHONG, fn, 100, n_pix, **_caps(bins))
        fn, bins = bench_fwd_bwd_soft(scene_hl, cfg_soft, cam_ph)
        _row(rows, PINHOLE_SOFT, fn, 20, n_pix, **_caps(bins))

    ts = _row(rows, TRAIN, bench_train_step(scene_hl, cfg_soft, cam), 20, n_pix)
    _graph_row(ts, TRAIN, graph_train_us(scene_hl, cfg_soft, cam), 10)
    mesh = bench_mesh_rows(args, scene_hl, cfg_hl, cam)

    parity = bench_parity(device)
    print("# parity (scene 1, on the card): legacy identical "
          f"{parity['parity_legacy_frac_identical']:.4f}, phong close "
          f"{parity['parity_phong_frac_close']:.4f}, soft-grad max err "
          f"{parity['parity_soft_grad_max_err']:.2e}, pixel-grad max err "
          f"{parity['parity_pixel_grad_max_err']:.2e}", file=sys.stderr)

    print(json.dumps({
        "metric": "primary_rays_per_s_1080p_fwd_phong_shadows",
        "value": head["rays_per_s"],
        "unit": "rays/s",
        "value_min": rays_per_second(n_pix, head["ms_max"]),
        "value_max": rays_per_second(n_pix, head["ms_min"]),
        "sol_fraction": head["sol_fraction"],
        "sol_bound": head["sol_bound"],
        "dynamic_frame_ms": dyn["ms"],
        "fwd_bwd_rays_per_s": fb["rays_per_s"],
        "sol_fraction_bwd": fb["sol_fraction_bwd"],
        "sol_bwd_bound": fb["sol_bwd_bound"],
        **({"stress_fwd_bwd_rays_per_s": stress["rays_per_s"]}
           if stress is not None else {}),
        "train_step_ms": ts["ms"],
        "headline_graph_us": head["device_graph_us"],
        "dynamic_graph_us": dyn["device_graph_us"],
        "fwd_bwd_graph_us": fb["device_graph_us"],
        "train_graph_us": ts["device_graph_us"],
        **mesh,
        "rows": rows,
        **parity,
        "device": smi,
        "device_kind": device_kind(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
