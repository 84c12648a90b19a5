#!/usr/bin/env python3
"""How the tiled soft frame depends on its tile grid, on one NVIDIA card:

    PYTHONPATH=. python scripts/torch_soft_tiling.py

The 1080p headline scene (10 spheres + 1 cube, `random_scene(10, 1,
seed=0)`), soft, tau_depth 1.0, tau_edge 0.5, lambert and phong + soft
shadows, legacy ortho camera. For each: the unsharded tiled frame
(`render_soft_tiled`, B4) and the frame as 4 row blocks of 270 rows render
it (`parallel.mesh._render_rows` through the row-shifted camera, each block
on its own tiles), each against the other and against the
`diff.render_soft` oracle (no tiles, no cull); then the same with the
16-tau_edge cull raised to 1e4 tau_edge, where every tile takes every
primitive. Prints, per case, the largest per-pixel difference (0..255) and
the pixels over 1e-2.
"""

import subprocess

import torch

import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu_torch.diff import render_soft
from opencl_ray_tracer_tpu_torch.kernels import soft_tiled
from opencl_ray_tracer_tpu_torch.parallel import shift_camera_rows
from opencl_ray_tracer_tpu_torch.parallel.mesh import _render_rows


def _diff(a, b):
    d = (a - b).abs().amax(-1)
    return f"max {d.max().item():.5f}, {(d > 1e-2).sum().item()} pixels over 1e-2"


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: this script runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    w, h, n = 1920, 1080, 4
    scene = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
    cam = T.legacy_ortho_camera(device=dev)
    for shading, shadows in (("lambert", False), ("phong", True)):
        cfg = T.RenderConfig(width=w, height=h, shading=shading, shadows=shadows,
                             soft=True, framebuffer_dtype="float", tau_depth=1.0,
                             tau_edge=0.5)
        with torch.no_grad():
            oracle = render_soft(scene, cam, cfg)
        for sigmas in (soft_tiled.SOFT_CULL_SIGMAS, 1e4):
            saved, soft_tiled.SOFT_CULL_SIGMAS = soft_tiled.SOFT_CULL_SIGMAS, sigmas
            try:
                with torch.no_grad():
                    full = soft_tiled.render_soft_tiled(scene, cam, cfg)
                    hl = h // n
                    blocks = torch.cat([
                        _render_rows(scene, shift_camera_rows(cam, r * hl), hl, w, cfg)
                        for r in range(n)])
            finally:
                soft_tiled.SOFT_CULL_SIGMAS = saved
            print(f"{shading} shadows={shadows} cull {sigmas:g} tau_edge: "
                  f"unsharded vs oracle {_diff(full, oracle)}; {n} blocks vs "
                  f"unsharded {_diff(blocks, full)}; {n} blocks vs oracle "
                  f"{_diff(blocks, oracle)}; {smi}")


if __name__ == "__main__":
    main()
