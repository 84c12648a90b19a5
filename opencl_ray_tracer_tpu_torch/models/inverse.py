"""Inverse rendering: fit scene parameters to a target image.

Given a target framebuffer, optimize sphere centers/radii/colours, cube
vertices and light parameters by gradient descent through the soft
differentiable renderer, with the train step of parallel/train.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from opencl_ray_tracer_tpu_torch.camera import Camera, legacy_ortho_camera
from opencl_ray_tracer_tpu_torch.config import RenderConfig
from opencl_ray_tracer_tpu_torch.parallel.mesh import (
    mesh_from_config,
    replicate,
    shard_rows,
)
from opencl_ray_tracer_tpu_torch.parallel.train import (
    adam,
    init_train_state,
    make_train_step,
    scene_snapshot,
)
from opencl_ray_tracer_tpu_torch.utils.log import log_info

# Leaves whose names make sense to optimize by default (geometry + colour).
SPHERE_PARAMS = ("sphere_origin", "sphere_radius", "sphere_colour")


def param_filter_from_names(names) -> Callable[[str], bool]:
    """Filter over leaf names ("sphere_origin", "lights.position", ...): a
    leaf is trainable when any part of its dotted name is in `names`."""
    names = tuple(names)

    def fltr(leaf_name: str) -> bool:
        return any(k in names for k in leaf_name.split("."))

    return fltr


def perturb_scene(scene, seed: int = 0, origin_sigma: float = 20.0,
                  radius_scale: float = 0.25, colour_sigma: float = 0.15):
    """Jittered copy of a scene, the standard start of a recovery run:
    Gaussian sphere-origin offsets, a multiplicative radius jitter and RGB
    colour noise, drawn with numpy's default_rng(seed) exactly as the JAX
    package draws them (so both give bit-identical scenes); triangles and
    lights are left exact."""
    rng = np.random.default_rng(seed)
    so = scene.sphere_origin.detach().cpu().numpy()
    sr = scene.sphere_radius.detach().cpu().numpy()
    sc = scene.sphere_colour.detach().cpu().numpy()
    so = so + rng.normal(0.0, origin_sigma, so.shape).astype(np.float32)
    sr = sr * (1.0 + rng.uniform(-radius_scale, radius_scale, sr.shape)).astype(
        np.float32
    )
    sc = sc.copy()
    if sc.size:
        sc[:, :3] = np.clip(
            sc[:, :3] + rng.normal(0.0, colour_sigma, sc[:, :3].shape), 0.05, 1.0
        ).astype(np.float32)
    dev = scene.device
    return dataclasses.replace(
        scene,
        sphere_origin=torch.from_numpy(so).to(dev),
        sphere_radius=torch.from_numpy(sr).to(dev),
        sphere_colour=torch.from_numpy(sc).to(dev),
    )


def fit_scene(
    init_scene,
    target,
    camera: Optional[Camera] = None,
    config: Optional[RenderConfig] = None,
    steps: int = 200,
    learning_rate: float = 0.5,
    trainable: Optional[tuple] = None,
    mesh=None,
    log_every: int = 50,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 50,
):
    """Gradient-fit `init_scene` to `target` (H, W, 4 in the 0..255 domain).
    Returns (scene, losses). Uses Adam; `trainable` optionally restricts the
    fit to named scene fields (e.g. SPHERE_PARAMS).

    Rows are sharded over `mesh`, or else over `mesh_from_config(config)`:
    every rank of the process group for mesh_shape None, one rank (the
    scene's device, no communication) without a group. Each rank calls
    this with the same arguments; the target's rows are split here and the
    scene is broadcast from rank 0.

    The step is the compiled one (`make_train_step(jit=True)`), as the
    JAX package's fit always runs its jitted step: on a card one CUDA graph
    a step, all-reduce included; on the CPU the same step eagerly. Each
    loss is read (`float`) at once at the `log_every` points: the next
    replay overwrites it.

    With `checkpoint_dir`, the TrainState (scene + optimizer + step) is
    saved every `checkpoint_every` steps and at the end (by rank 0), and a
    killed run resumes from the latest checkpoint on the next call."""
    config = config or RenderConfig(
        width=int(target.shape[1]), height=int(target.shape[0]),
        shading="lambert", soft=True, framebuffer_dtype="float",
    )
    mesh = mesh or mesh_from_config(config)
    scene = replicate(init_scene, mesh)
    camera = camera or legacy_ortho_camera(device=scene.device)
    fltr = param_filter_from_names(trainable) if trainable else None
    optimizer = adam(learning_rate)
    step = make_train_step(camera, config, optimizer, mesh=mesh,
                           param_filter=fltr, jit=True)

    target = torch.as_tensor(np.asarray(
        target.detach().cpu() if isinstance(target, torch.Tensor) else target,
        np.float32))
    target = shard_rows(target, mesh).to(scene.device)
    state = init_train_state(scene, optimizer)
    if checkpoint_dir:
        from opencl_ray_tracer_tpu_torch.parallel.checkpoint import (
            resume_or_init,
            save_checkpoint,
        )

        state = resume_or_init(checkpoint_dir, state)
    start = int(state.step)

    losses = []
    for i in range(start, steps):
        state, loss = step(state, target)
        if i % log_every == 0 or i == steps - 1:
            lv = float(loss)
            losses.append(lv)
            log_info("fit_scene step %d loss %.6f", i, lv)
        if checkpoint_dir and ((i + 1) % checkpoint_every == 0 or i == steps - 1):
            save_checkpoint(checkpoint_dir, state, mesh=mesh)
    return scene_snapshot(state.scene), losses
