"""The frames loop of `frames.py` through the port's compiled frame,
`models.renderer.render_jit`: what callers that compile the frame once run
(the JAX package's `jit(render_tiled)`). `render_jit(config)` is built once
in the set-up; each frame is one call of it, a captured CUDA graph replayed
with the camera copied in (the config's K caps fixed, the brute kernel
taking over on the card where a tile's list overflows, no host read of the
overflow flag), then the fence.

The camera path, the frames sampled for the check, the check and the
control are `frames.py`'s, and so are the inputs this loop keeps, so the
frames' metric readers read both loops. A sampled frame is cloned, since a
call returns the graph's static output, which the next replay overwrites."""

from __future__ import annotations

import time

import torch

from rtbench.lib import files, scenes

frames = files.load("loops", "frames")
check = frames.check
control = frames.control
release = frames.release


def setup(run):
    from opencl_ray_tracer_tpu_torch import RenderConfig, pinhole_camera
    from opencl_ray_tracer_tpu_torch.models.renderer import render_jit
    from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays

    cfg, tr, dev = run.config, run.traffic, run.device
    mode = cfg["modes"][tr["mode"]]
    w, h = cfg["width"], cfg["height"]
    arrays = scenes.make_scene(cfg["scene"], run.seed, dev)
    scene = scene_from_arrays(arrays, dev)
    rcfg = RenderConfig(width=w, height=h, **mode).validate()
    fwd = render_jit(rcfg)
    cams = frames.orbit_cameras(tr["orbit"], w, h)
    g = scenes.generator(run.seed, "cpu")
    n_turn = tr["orbit"]["frames_per_turn"]
    start = int(torch.randint(n_turn, (1,), generator=g))
    order = frames.frame_order(tr["orbit"], start)
    sample = {0} | {int(i) for i in torch.randperm(n_turn, generator=g)
                    [: tr["check_frames"] - 1]}
    program_cams = [pinhole_camera(position=c["position"], look_at=c["look_at"],
                                   up=c["up"], fov_degrees=c["fov_degrees"],
                                   width=w, height=h, device=dev) for c in cams]
    warm_until = time.perf_counter() + tr["warmup_seconds"]
    i = 0
    while i == 0 or time.perf_counter() < warm_until:
        fwd(scene, program_cams[order(i)])  # the first call captures
        run.sync()
        i += 1
    kept = {}
    run.inputs.update(arrays=arrays, cams=cams, order=order, mode=mode,
                      kept=kept, frame_keys=[],
                      sample_keys=[order(i) for i in sorted(sample)])
    spans, sync = run.spans, run.sync
    run.inputs["program"] = (scene, program_cams, rcfg)

    def unit(i):
        k = order(i)
        t0 = time.perf_counter()
        with spans("frame.issue"):
            fb = fwd(scene, program_cams[k])
        with spans("frame.fence"):
            sync()
        lat = time.perf_counter() - t0
        if spans.on:
            run.inputs["frame_keys"].append(k)
        if i in sample:
            kept[i] = (k, fb.clone())
        return lat

    return unit
