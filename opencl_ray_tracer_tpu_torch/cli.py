"""CLI — the framework's main() (the reference's RayTrace/main.cpp role).

Subcommands:

  render    render a library scene to PNG on the card, on a chosen backend
  devices   device capability dump (openCLInit's platform/device listing)

The JAX package's compare, app, bench and fit subcommands are not ported
yet (ROADMAP A10).

Usage: python -m opencl_ray_tracer_tpu_torch.cli <subcommand> [options]
"""

from __future__ import annotations

import argparse
import sys
import time


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
        "--backend", choices=["reference", "pallas"], default=None,
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
    from opencl_ray_tracer_tpu_torch.utils import write_png

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: render runs on the card")
    device = torch.device("cuda")
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
    return 0


def cmd_devices(args) -> int:
    from opencl_ray_tracer_tpu_torch.runtime import describe_devices

    for line in describe_devices():
        print(line)
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

    p = sub.add_parser("devices", help="device capability dump")
    p.set_defaults(fn=cmd_devices)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
