#!/usr/bin/env python
"""Inverse-rendering demo on the PyTorch/CUDA port.

Renders a target image from a ground-truth scene with the soft renderer,
perturbs the scene, then recovers sphere geometry + colours by gradient
descent through the differentiable renderer on the pallas backend (the
tiled soft kernels B4 forward and B5 backward, on the card). One process
fits on one card; started under torchrun it joins the process group, one
card a rank, and the image rows are sharded over the ranks with the scene
gradients all-reduced (as `cli fit` does).

On one card:   python examples/torch_inverse_rendering_demo.py
On 4 cards:    torchrun --nproc_per_node=4 examples/torch_inverse_rendering_demo.py
Tiny on CPU:   python examples/torch_inverse_rendering_demo.py --device cpu \\
                   --width 128 --height 64 --steps 3
(on the CPU the kernels' plain twins run).
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--out-prefix",
                    default=os.path.join(tempfile.gettempdir(), "inverse_demo"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; raises without one) or cpu")
    args = ap.parse_args(argv)

    import torch

    from opencl_ray_tracer_tpu_torch import RenderConfig, legacy_ortho_camera
    from opencl_ray_tracer_tpu_torch.diff import render_soft
    from opencl_ray_tracer_tpu_torch.models.inverse import SPHERE_PARAMS, fit_scene
    from opencl_ray_tracer_tpu_torch.parallel import distributed, mesh_from_config
    from opencl_ray_tracer_tpu_torch.runtime import card_or
    from opencl_ray_tracer_tpu_torch.scene import Scene
    from opencl_ray_tracer_tpu_torch.utils import write_png

    device = card_or(args.device, "the demo")
    # under torchrun, one rank a card (gloo ranks on the CPU)
    distributed.initialize(backend="gloo" if device.type == "cpu" else None)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    rank0 = distributed.rank() == 0

    w, h = args.width, args.height
    cfg = RenderConfig(
        width=w, height=h, shading="lambert", soft=True,
        framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.75,
        backend="pallas",
    )
    cam = legacy_ortho_camera(device=device)
    mesh = mesh_from_config(cfg)
    print(f"device: {device}  mesh: {mesh.shape}")

    true_scene = Scene.build(
        device=device,
        sphere_origin=[
            [w * 0.3, h * 0.5, -50.0],
            [w * 0.65, h * 0.4, -70.0],
        ],
        sphere_radius=[h * 0.22, h * 0.3],
        sphere_colour=[[1.0, 0.25, 0.2, 255.0], [0.2, 0.4, 1.0, 255.0]],
    )
    init_scene = Scene.build(
        device=device,
        sphere_origin=[
            [w * 0.38, h * 0.42, -50.0],
            [w * 0.58, h * 0.52, -70.0],
        ],
        sphere_radius=[h * 0.16, h * 0.24],
        sphere_colour=[[0.7, 0.5, 0.4, 255.0], [0.4, 0.4, 0.7, 255.0]],
    )
    with torch.no_grad():
        target = render_soft(true_scene, cam, cfg)
        if rank0:
            write_png(f"{args.out_prefix}_target.png", target)
            write_png(f"{args.out_prefix}_init.png",
                      render_soft(init_scene, cam, cfg))

    fitted, losses = fit_scene(
        init_scene, target, camera=cam, config=cfg, steps=args.steps,
        learning_rate=0.5, trainable=SPHERE_PARAMS, mesh=mesh, log_every=25,
    )
    if rank0:
        with torch.no_grad():
            write_png(f"{args.out_prefix}_fitted.png", render_soft(fitted, cam, cfg))
        print("\ntrue origins:\n", true_scene.sphere_origin.cpu().numpy())
        print("fitted origins:\n", fitted.sphere_origin.detach().cpu().numpy())
        print("true radii:", true_scene.sphere_radius.cpu().numpy())
        print("fitted radii:", fitted.sphere_radius.detach().cpu().numpy())
        print(f"loss: {losses[0]:.6f} -> {losses[-1]:.6f}")
        print(f"wrote {args.out_prefix}_{{target,init,fitted}}.png")
    return {"losses": losses, "scene": fitted}


if __name__ == "__main__":
    main()
