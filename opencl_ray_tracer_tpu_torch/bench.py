"""Benchmark of the port on one NVIDIA card. Prints ONE JSON line on stdout:

  {"metric": ..., "value": N, "unit": "rays/s", "rows": {...}, ...}

    python -m opencl_ray_tracer_tpu_torch.bench [--skip-context]
    python -m opencl_ray_tracer_tpu_torch.bench --scene 1 --shading phong

Headline: primary rays/s at 1080p, forward, on the 10 spheres + 1 cube
scene (phong + hard shadows) through the tiled CUDA kernel emitting the
packed int32 framebuffer, with scene-static bins (the frame is the
coefficient gather plus the kernel). Further rows: the soft differentiable
forward + backward with every gradient leaf consumed, the train step, and
(unless --skip-context) the tiled legacy frame under both cameras and the
brute kernel's legacy frame; then parity scalars of scene 1 (tiled vs the
oracle, soft gradients vs the torch-autograd oracle, pixel-gradient rows).

Every row is the median and [min, max] of per-call CUDA-event times
(bench_util.call_times_ms): the host's work inside a call counts. Rows go
to stderr, the JSON line to stdout. Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from opencl_ray_tracer_tpu_torch.bench_util import call_times_ms, median_spread

W, H = 1920, 1080

HEADLINE = "headline tiled phong+shadows 1080p 10sph+1cube (packed fb)"
FWD_BWD = "fwd+bwd soft phong+shadows 1080p 10sph+1cube"
TRAIN = "train step (adam) soft phong+shadows 1080p"
TILED_LEGACY = "tiled legacy 1080p 10sph+1cube (packed fb)"
TILED_PINHOLE = "tiled legacy 1080p pinhole (projective culling)"
BRUTE_LEGACY = "brute legacy 1080p 10sph+1cube"


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
                    help="headline, fwd+bwd, train-step and parity rows only")
    return ap.parse_args(argv)


def row_plan(args) -> list:
    """Labels of the timed rows this invocation runs, in order."""
    if args.scene is not None:
        return [f"scene{args.scene} {args.shading} {args.width}x{args.height}"]
    rows = [HEADLINE, FWD_BWD]
    if not args.skip_context:
        rows += [TILED_LEGACY, TILED_PINHOLE, BRUTE_LEGACY]
    return rows + [TRAIN]


def _row(rows, label, samples, n_pix):
    ms, lo, hi = median_spread(samples)
    rows[label] = {"ms": ms, "ms_min": lo, "ms_max": hi,
                   "rays_per_s": n_pix / (ms / 1e3)}
    print(f"# {label}: {ms:.4f} ms [{lo:.4f}, {hi:.4f}] -> "
          f"{rows[label]['rays_per_s']:.3e} rays/s over {len(samples)} calls",
          file=sys.stderr)
    return rows[label]


def bench_tiled(scene, config, cam, n=100):
    """Per-call times of the tiled frame with scene-static bins."""
    from opencl_ray_tracer_tpu_torch.kernels.fwd_tiled import (
        bin_for_config,
        render_tiled_packed,
    )

    packed = scene.pack()
    bins = bin_for_config(packed, cam, config)
    return call_times_ms(
        lambda: render_tiled_packed(packed, cam, config, bins=bins), n)


def bench_brute(scene, config, cam, n=30):
    from opencl_ray_tracer_tpu_torch.kernels import render_pallas_packed

    packed = scene.pack()
    return call_times_ms(lambda: render_pallas_packed(packed, cam, config), n)


def bench_fwd_bwd_soft(scene, config, cam, n=20):
    """Forward + backward through the tiled soft kernels, gradients for
    every scene leaf, each of them consumed."""
    import torch

    from opencl_ray_tracer_tpu_torch.kernels.soft import render_soft_pallas
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

    return call_times_ms(step, n)


def bench_train_step(scene, config, cam, n=20):
    import torch

    from opencl_ray_tracer_tpu_torch.parallel import (
        adam,
        init_train_state,
        make_train_step,
    )

    step = make_train_step(cam, config)
    state = init_train_state(scene, adam(1e-3))
    target = torch.zeros((config.height, config.width, 4), dtype=torch.float32,
                         device=scene.sphere_origin.device)
    return call_times_ms(lambda: step(state, target), n)


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
    from opencl_ray_tracer_tpu_torch.ref import render_reference

    cam = legacy_ortho_camera(device=device)
    scene = create_scene(1, seed=0, device=device)
    out = {}
    cfg_i = RenderConfig(width=640, height=480, shading="legacy")
    a, b = render_tiled(scene, cam, cfg_i), render_reference(scene, cam, cfg_i)
    out["parity_legacy_frac_identical"] = (a == b).all(-1).float().mean().item()
    cfg_f = RenderConfig(width=640, height=480, shading="phong", shadows=True,
                         framebuffer_dtype="float")
    af, bf = render_tiled(scene, cam, cfg_f), render_reference(scene, cam, cfg_f)
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

    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(device)
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
        r = _row(rows, plan[0], bench_tiled(scene, cfg, cam), n_pix)
        print(json.dumps({
            "metric": f"rays_per_s_scene{args.scene}_{args.shading}_{wid}x{hgt}",
            "value": r["rays_per_s"], "unit": "rays/s", "rows": rows,
            "device": smi,
        }))
        return 0

    scene_hl = random_scene(10, 1, seed=0,
                            bounds=(float(wid) - 10, float(hgt) - 10),
                            device=device)
    cfg_hl = RenderConfig(width=wid, height=hgt, shading="phong", shadows=True,
                          framebuffer_dtype="packed")
    head = _row(rows, HEADLINE, bench_tiled(scene_hl, cfg_hl, cam), n_pix)

    cfg_soft = RenderConfig(width=wid, height=hgt, shading="phong", shadows=True,
                            soft=True, framebuffer_dtype="float", tau_depth=1.0,
                            tau_edge=0.5)
    fb = _row(rows, FWD_BWD, bench_fwd_bwd_soft(scene_hl, cfg_soft, cam), n_pix)

    if not args.skip_context:
        cfg_legacy = RenderConfig(width=wid, height=hgt, shading="legacy",
                                  framebuffer_dtype="packed")
        _row(rows, TILED_LEGACY, bench_tiled(scene_hl, cfg_legacy, cam), n_pix)
        cam_ph = pinhole_camera(
            position=(wid / 2.0, hgt / 2.0, 900.0),
            look_at=(wid / 2.0, hgt / 2.0, -85.0),
            fov_degrees=60.0, width=wid, height=hgt, device=device)
        _row(rows, TILED_PINHOLE, bench_tiled(scene_hl, cfg_legacy, cam_ph), n_pix)
        # the brute kernel has no packed-word output: its own int framebuffer
        _row(rows, BRUTE_LEGACY,
             bench_brute(scene_hl, cfg_legacy.replace(framebuffer_dtype="int"),
                         cam), n_pix)

    ts = _row(rows, TRAIN, bench_train_step(scene_hl, cfg_soft, cam), n_pix)

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
        "value_min": n_pix / (head["ms_max"] / 1e3),
        "value_max": n_pix / (head["ms_min"] / 1e3),
        "fwd_bwd_rays_per_s": fb["rays_per_s"],
        "train_step_ms": ts["ms"],
        "rows": rows,
        **parity,
        "device": smi,
        "device_kind": kind,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
