"""CLI — the framework's main() (the reference's RayTrace/main.cpp role).

Subcommands:

  render    render a library scene to PNG on the card, on a chosen backend
  compare   the reference app's whole purpose: run the same scene on the
            CPU oracle (backend "reference", on the host CPU) and on the
            card, print both wall times and the cross-check result (the
            F1 toggle as a one-shot)
  app       interactive benchmark shell on the card (state machine + input
            manager; --keys for a scripted run)
  fit       inverse rendering on the card: recover a perturbed library
            scene's spheres through the soft differentiable renderer
  devices   device capability dump (openCLInit's platform/device listing)
  bench     the port's benchmark on the card (one JSON line on stdout);
            arguments after `bench` go to opencl_ray_tracer_tpu_torch.bench

render, compare, app and fit raise without a card; compare's and app's
logic (`compare_frames`, app.MainState) takes a device, so it also runs on
the CPU when asked.

Usage: python -m opencl_ray_tracer_tpu_torch.cli <subcommand> [options]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from opencl_ray_tracer_tpu_torch.runtime import card_or


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--scene", type=int, default=1, help="scene number 1-3")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--shading", choices=["legacy", "lambert", "phong"], default="legacy"
    )
    p.add_argument("--shadows", action="store_true")
    p.add_argument(
        "--backend", choices=["reference", "xla", "pallas"], default=None,
        help="default: the config's backend (pallas, the CUDA kernel)"
    )
    p.add_argument("--settings", help="XML or JSON settings/config file")
    p.add_argument("--msaa", type=int, default=None,
                   choices=[0, 1, 2, 4, 8, 16],
                   help="supersampling samples/pixel (overrides settings)")
    p.add_argument("--camera", choices=["ortho", "pinhole"], default="ortho",
                   help="legacy shared-direction ortho or a real pinhole")
    p.add_argument("--cam-pos", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--cam-look", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--show", action="store_true",
                   help="print the framebuffer to the terminal "
                        "(24-bit ANSI half-blocks)")


def _config_from(args):
    from opencl_ray_tracer_tpu_torch.config import RenderConfig, Settings

    msaa = 0
    if args.settings:
        if args.settings.endswith(".xml"):
            s = Settings.from_xml(args.settings)
            args.width, args.height = s.width, s.height
            msaa = s.msaa
        else:
            cfg = RenderConfig.from_json(args.settings)
            if args.msaa is not None:
                cfg = cfg.replace(msaa=args.msaa)
            return cfg
    if args.msaa is not None:
        msaa = args.msaa
    fb = "float" if args.shading != "legacy" else "int"
    return RenderConfig(
        width=args.width,
        height=args.height,
        shading=args.shading,
        shadows=args.shadows,
        framebuffer_dtype=fb,
        msaa=msaa,
    ).validate()


def _camera_from(args, cfg, device):
    from opencl_ray_tracer_tpu_torch import legacy_ortho_camera, pinhole_camera

    if args.camera == "pinhole":
        # close enough that legacy depth-fog (black past t=180,
        # rayTracer.cl:193) still shows the scene
        pos = args.cam_pos or [cfg.width / 2.0, cfg.height / 2.0, 80.0]
        look = args.cam_look or [cfg.width / 2.0, cfg.height / 2.0, -60.0]
        return pinhole_camera(
            position=tuple(pos), look_at=tuple(look),
            fov_degrees=args.fov, width=cfg.width, height=cfg.height,
            device=device,
        )
    return legacy_ortho_camera(device=device)


def cmd_render(args) -> int:
    import torch

    from opencl_ray_tracer_tpu_torch import create_scene, render
    from opencl_ray_tracer_tpu_torch.utils import show, write_png

    device = card_or(None, "render")
    cfg = _config_from(args)
    if args.packed:
        cfg = cfg.replace(framebuffer_dtype="packed")
    scene = create_scene(args.scene, seed=args.seed, device=device)
    cam = _camera_from(args, cfg, device)
    t0 = time.perf_counter()
    fb = render(scene, cam, cfg, backend=args.backend)
    torch.cuda.synchronize(device)
    us = (time.perf_counter() - t0) * 1e6
    print(f"scene {args.scene} {cfg.width}x{cfg.height} device={device} "
          f"backend={args.backend or cfg.backend}: {us:.0f} us (first frame, "
          f"includes the kernel build)")
    write_png(args.out, fb)
    print(f"wrote {args.out}")
    if args.show:
        show(fb)
    return 0


def cross_check(fb_cpu, fb_acc):
    """The reference's F1 cross-check: int frames must be identical on
    more than 99.9% of pixels, float frames within 0.5/255 on more than
    99.9%. Returns (the line to print, ok)."""
    a = fb_cpu.detach().cpu().numpy()
    b = fb_acc.detach().cpu().numpy()
    if a.dtype == np.int32:
        frac = np.all(a == b, axis=-1).mean()
        check = f"{frac:.4%} pixels identical"
    else:
        frac = (np.abs(a - b).max(axis=-1) < 0.5).mean()
        check = f"{frac:.4%} pixels within 0.5/255"
    return check, bool(frac > 0.999)


def compare_frames(scene, cam, cfg, accel: str):
    """The same frame on the CPU oracle and on backend `accel` (on the
    scene's device): both timed with time_fn (the oracle 3 calls a batch
    after 1 warm-up, `accel` 10 after 2), then cross-checked. Returns
    (stats, check, ok): stats holds time_fn's dict of each leg ("cpu",
    "accel") and the device each frame lay on ("cpu_device",
    "accel_device")."""
    from opencl_ray_tracer_tpu_torch import render
    from opencl_ray_tracer_tpu_torch.utils import time_fn
    from opencl_ray_tracer_tpu_torch.utils.timer import fence

    fb_cpu = render(scene, cam, cfg, backend="reference")
    fb_acc = render(scene, cam, cfg, backend=accel)
    fence((fb_cpu, fb_acc))
    stats = {
        "cpu": time_fn(lambda: render(scene, cam, cfg, backend="reference"),
                       iters=3, warmup=1),
        "accel": time_fn(lambda: render(scene, cam, cfg, backend=accel),
                         iters=10, warmup=2),
        "cpu_device": str(fb_cpu.device),
        "accel_device": str(fb_acc.device),
    }
    check, ok = cross_check(fb_cpu, fb_acc)
    return stats, check, ok


def cmd_compare(args) -> int:
    """CPU oracle vs the card: times + pixel cross-check; exit 0 on OK."""
    import torch

    from opencl_ray_tracer_tpu_torch import create_scene
    from opencl_ray_tracer_tpu_torch.runtime import default_backend

    device = card_or(None, "compare")
    cfg = _config_from(args)
    scene = create_scene(args.scene, seed=args.seed, device=device)
    cam = _camera_from(args, cfg, device)
    accel = args.backend or default_backend().value
    stats, check, ok = compare_frames(scene, cam, cfg, accel)

    n_rays = cfg.width * cfg.height
    cpu_us, acc_us = stats["cpu"]["median_us"], stats["accel"]["median_us"]
    card = torch.cuda.get_device_name(device)
    print(f"scene {args.scene}  {cfg.width}x{cfg.height}  shading={cfg.shading}")
    print(f"  CPU (reference) [{stats['cpu_device']}]: {cpu_us:>12.0f} us   "
          f"{n_rays / (cpu_us / 1e6):.3e} rays/s")
    print(f"  {accel} [{stats['accel_device']} {card}]: {acc_us:>12.0f} us   "
          f"{n_rays / (acc_us / 1e6):.3e} rays/s")
    print(f"  speedup: {cpu_us / acc_us:.1f}x")
    print(f"  cross-check: {check} -> {'OK' if ok else 'MISMATCH'}")
    return 0 if ok else 1


def cmd_app(args) -> int:
    from opencl_ray_tracer_tpu_torch.app import (
        InputManager, MainState, StateManager, run_interactive, run_scripted,
    )

    device = card_or(None, "app")
    cfg = _config_from(args)
    manager = StateManager()
    state = MainState(manager, InputManager(), config=cfg,
                      scene_seed=args.seed, display=args.display, device=device)
    manager.add_state(state)
    if args.keys:
        for line in run_scripted(manager, list(args.keys.split(","))):
            print(line)
    else:
        run_interactive(manager)
    return 0


def cmd_fit(args) -> int:
    """Render the chosen library scene through the chosen camera/shading as
    the target (with the soft oracle), perturb its sphere parameters and
    recover them by gradient descent through the soft renderer (the
    compiled step of `fit_scene`: one CUDA graph a step, through the tiled
    soft kernels for backend pallas), with optional checkpoint/resume."""
    import torch

    from opencl_ray_tracer_tpu_torch import create_scene
    from opencl_ray_tracer_tpu_torch.diff import render_soft
    from opencl_ray_tracer_tpu_torch.models.inverse import (
        SPHERE_PARAMS,
        fit_scene,
        perturb_scene,
    )
    from opencl_ray_tracer_tpu_torch.parallel import distributed
    from opencl_ray_tracer_tpu_torch.utils import write_png

    card_or(None, "fit")
    # under torchrun, one card a rank: the fit's rows shard over the ranks
    distributed.initialize()
    device = torch.device("cuda")
    shading = args.shading if args.shading != "legacy" else "lambert"
    cfg = _config_from(args).replace(
        shading=shading, soft=True, framebuffer_dtype="float",
        tau_depth=1.0, tau_edge=0.5, msaa=0,
        **({"backend": args.backend} if args.backend else {}),
    )
    cam = _camera_from(args, cfg, device)
    true_scene = create_scene(args.scene, seed=args.seed, device=device)
    with torch.no_grad():
        target = render_soft(true_scene, cam, cfg)
    init = perturb_scene(true_scene, seed=args.seed + 1)
    t0 = time.perf_counter()
    fitted, losses = fit_scene(
        init, target, camera=cam, config=cfg, steps=args.steps,
        learning_rate=args.lr, trainable=SPHERE_PARAMS,
        log_every=max(args.steps // 10, 1),
        checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_every=args.checkpoint_every,
    )
    torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    true_o = true_scene.sphere_origin.cpu().numpy()
    err0 = np.abs(init.sphere_origin.cpu().numpy() - true_o).max()
    err1 = np.abs(fitted.sphere_origin.cpu().numpy() - true_o).max()
    print(f"scene {args.scene} camera={args.camera} shading={shading} "
          f"backend={cfg.backend}: max origin error {err0:.2f} -> {err1:.2f}")
    if losses:
        print("loss: %.6f -> %.6f" % (losses[0], losses[-1]))
    print(f"{args.steps} steps in {secs:.2f} s on {torch.cuda.get_device_name(device)} "
          f"(includes the kernel build on a first run)")
    if args.out and distributed.rank() == 0:
        with torch.no_grad():
            write_png(args.out, render_soft(fitted, cam, cfg))
        print(f"wrote {args.out}")
    return 0


def cmd_bench(args) -> int:
    """`bench`: the port's benchmark (opencl_ray_tracer_tpu_torch.bench) with
    `args.bench_args` forwarded whole; its exit code."""
    from opencl_ray_tracer_tpu_torch import bench

    return bench.main(list(args.bench_args))


def cmd_devices(args) -> int:
    from opencl_ray_tracer_tpu_torch.runtime import default_device, describe_devices

    for line in describe_devices():
        print(line)
    print("selected:", default_device())
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="opencl_ray_tracer_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a scene to PNG")
    _add_common(p)
    p.add_argument("--out", default="render.png")
    p.add_argument("--packed", action="store_true",
                   help="packed int32 framebuffer (the kernel emits the "
                        "RGBA words directly)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("compare", help="CPU vs card comparison")
    _add_common(p)
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("app", help="interactive benchmark shell")
    _add_common(p)
    p.add_argument("--keys", help="comma-separated scripted key events")
    p.add_argument("--display", action="store_true",
                   help="re-blit the terminal framebuffer after every "
                        "trace (the per-frame window blit, headless)")
    p.set_defaults(fn=cmd_app)

    p = sub.add_parser("fit", help="inverse rendering on the card")
    _add_common(p)
    # the scene library lives in the reference's 640x480 world box: smaller
    # windows would crop the scene out of frame and fit an empty target
    p.set_defaults(width=640, height=480)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.5)
    p.add_argument("--checkpoint-dir", default="",
                   help="save/resume TrainState checkpoints here")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--out", default="")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("devices", help="device capability dump")
    p.set_defaults(fn=cmd_devices)

    sub.add_parser("bench", help="benchmark on the card (one JSON line); "
                                 "its arguments go to the bench module")

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["bench"]:  # forwarded whole: options included
        return cmd_bench(argparse.Namespace(bench_args=argv[1:]))
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
