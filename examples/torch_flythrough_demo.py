#!/usr/bin/env python
"""Pinhole camera flythrough on the PyTorch/CUDA port.

Orbits a real pinhole camera around scene 2 and renders every frame
through the tiled hard kernel (`kernels.fwd_tiled.render_tiled`: the CUDA
kernel B2 for the float phong + shadows frame, on the card), reporting
sustained frames/second and rays/second (the reference app renders one frame
per keypress; this is the same pipeline at animation rates). Optionally
dumps PNG frames and/or plays the sequence in the terminal as 24-bit ANSI
half-blocks (utils/display.py).

On the card:   python examples/torch_flythrough_demo.py --frames 120
Tiny on CPU:   python examples/torch_flythrough_demo.py --device cpu \\
                   --frames 2 --width 256 --height 128
(on the CPU the kernel's plain twin renders the frames).
"""

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--scene", type=int, default=2)
    ap.add_argument("--shading", default="phong",
                    choices=["legacy", "lambert", "phong"])
    ap.add_argument("--radius", type=float, default=600.0)
    ap.add_argument("--png-prefix", default="",
                    help="write frames as <prefix>NNN.png")
    ap.add_argument("--ansi", action="store_true",
                    help="play the frames in the terminal")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; raises without one) or cpu")
    return ap.parse_args(argv)


def setup(args):
    """(scene, config, camera_at) for the flythrough: camera_at(angle) is
    the pinhole camera on the orbit at `angle` radians."""
    from opencl_ray_tracer_tpu_torch import RenderConfig, create_scene, pinhole_camera
    from opencl_ray_tracer_tpu_torch.runtime import card_or

    device = card_or(args.device, "the flythrough")
    w, h = args.width, args.height
    cfg = RenderConfig(
        width=w, height=h, shading=args.shading,
        shadows=args.shading == "phong",
        framebuffer_dtype="int" if args.shading == "legacy" else "float",
    )
    scene = create_scene(args.scene, seed=0, device=device)
    center = (320.0, 240.0, -60.0)  # scene 2 lives in the 640x480 view box

    def camera_at(angle: float):
        return pinhole_camera(
            position=(
                center[0] + args.radius * math.sin(angle),
                center[1] - 120.0,
                center[2] + args.radius * math.cos(angle),
            ),
            look_at=center,
            fov_degrees=55.0,
            width=w,
            height=h,
            device=device,
        )

    return scene, cfg, camera_at


def main(argv=None):
    args = parse_args(argv)

    from opencl_ray_tracer_tpu_torch.kernels.fwd_tiled import render_tiled
    from opencl_ray_tracer_tpu_torch.utils import show, write_png
    from opencl_ray_tracer_tpu_torch.utils.timer import fence

    scene, cfg, camera_at = setup(args)
    w, h = cfg.width, cfg.height

    # warm up (the kernel build on a first run) on frame 0's camera
    fence(render_tiled(scene, camera_at(0.0), cfg))

    t0 = time.perf_counter()
    for i in range(args.frames):
        angle = 2.0 * math.pi * i / max(args.frames, 1)
        fb = render_tiled(scene, camera_at(angle), cfg)
        fence(fb)
        if args.png_prefix:
            write_png(f"{args.png_prefix}{i:03d}.png", fb)
        if args.ansi:
            print(f"\x1b[H\x1b[2J-- frame {i} --")
            show(fb)
    dt = time.perf_counter() - t0
    fps = args.frames / dt
    print(
        f"{args.frames} frames at {w}x{h} on {fb.device}: {dt:.2f}s -> "
        f"{fps:.1f} fps ({fps * w * h:.3e} rays/s sustained, incl. host loop)"
    )
    return {"frames": args.frames, "seconds": dt, "fps": fps}


if __name__ == "__main__":
    main()
