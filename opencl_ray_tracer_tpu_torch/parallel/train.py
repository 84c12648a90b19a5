"""Differentiable-rendering train step, on one device or over a rank mesh.

Fits scene parameters to a target image by gradient descent through the
soft renderer: a soft render (the tiled soft kernels for backend "pallas",
the torch-autograd oracle `diff.render_soft` otherwise), a mean squared
error over the RGB channels in 0..1 units, autograd to every scene leaf,
and an Adam step (`torch.optim.Adam` with optax.adam's defaults: b1 0.9,
b2 0.999, eps 1e-8 — the same update formula).

Over a mesh (parallel/mesh.py), as the JAX package's shard_map step:

  - image rows SHARDED over the ranks: each renders and takes the loss on
    its own block, through the row-shifted camera (no communication);
  - scene + optimizer state REPLICATED;
  - the block's loss and scene gradients are partial sums over its pixels,
    so one all-reduce completes them: THE collective of the workload, one
    flat buffer, over the ranks of a host first and then once across hosts
    on a (hosts, chips) mesh;
  - every rank then takes the same Adam step on the same reduced
    gradients, so the replicated state stays bit-identical across ranks.

A step updates the scene's leaf tensors in place.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, NamedTuple, Optional

import torch

from opencl_ray_tracer_tpu_torch.camera import Camera
from opencl_ray_tracer_tpu_torch.config import RenderConfig
from opencl_ray_tracer_tpu_torch.diff.soft import render_soft
from opencl_ray_tracer_tpu_torch.kernels.soft import render_soft_pallas
from opencl_ray_tracer_tpu_torch.parallel.mesh import (
    IMAGE_AXIS,
    Mesh,
    mesh_n_shards,
    shift_camera_rows,
)
from opencl_ray_tracer_tpu_torch.scene.scene import Lights, Scene

_SCENE_KEYS = ("sphere_origin", "sphere_radius", "sphere_colour", "tri_verts",
               "tri_colour")
_LIGHT_KEYS = ("position", "colour", "intensity", "ambient", "spec_strength",
               "shininess")


class TrainState(NamedTuple):
    scene: Scene                       # leaves are tensors with requires_grad
    opt_state: torch.optim.Optimizer   # holds the Adam moments of the leaves
    step: int


def scene_leaves(scene) -> Dict[str, torch.Tensor]:
    """Scene leaves by name ("sphere_origin", ..., "lights.position", ...),
    in a fixed order."""
    out = {k: getattr(scene, k) for k in _SCENE_KEYS}
    out.update({f"lights.{k}": getattr(scene.lights, k) for k in _LIGHT_KEYS})
    return out


def trainable_scene(scene) -> Scene:
    """A copy of the scene whose leaves are fresh tensors with
    requires_grad (the optimizer's parameters)."""
    leaf = lambda t: t.detach().clone().requires_grad_(True)  # noqa: E731
    lights = Lights(**{k: leaf(getattr(scene.lights, k)) for k in _LIGHT_KEYS})
    return Scene(**{k: leaf(getattr(scene, k)) for k in _SCENE_KEYS},
                 lights=lights)


def adam(learning_rate: float) -> Callable:
    """Optimizer factory: params -> torch.optim.Adam with optax.adam's
    defaults."""
    return functools.partial(torch.optim.Adam, lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8)


def init_train_state(scene, optimizer: Callable) -> TrainState:
    """`optimizer` builds the optimizer from a list of parameters (e.g.
    `adam(lr)`)."""
    scene = trainable_scene(scene)
    return TrainState(scene, optimizer(list(scene_leaves(scene).values())), 0)


def _all_reduce(mesh: Mesh, loss: torch.Tensor, grads):
    """(loss, grads) summed over the mesh: flattened into one buffer, so the
    whole exchange is one all-reduce per level."""
    flat = mesh.all_reduce(torch.cat([loss.reshape(1)]
                                     + [g.reshape(-1) for g in grads]))
    sizes = [1] + [g.numel() for g in grads]
    parts = torch.split(flat, sizes)
    return parts[0].reshape(()), [p.view_as(g) for p, g in zip(parts[1:], grads)]


def make_train_step(
    camera: Camera,
    config: RenderConfig,
    optimizer: Callable,
    mesh: Optional[Mesh] = None,
    axis: str = IMAGE_AXIS,
    param_filter: Optional[Callable[[str], bool]] = None,
) -> Callable:
    """Build the train step: step(state, target) -> (state, loss), the
    reference's call shape `make_train_step(camera, config, optimizer,
    mesh=mesh)`.

    `optimizer` is the factory the state's optimizer was built from
    (`init_train_state(scene, optimizer)`, e.g. `adam(lr)`); the update goes
    through `state.opt_state`, which holds the moments. With `mesh=None` the
    step runs on one device with no collective and `target` is the (H, W, 4)
    float32 frame. With a mesh, `target` is this rank's (H/n, W, 4) rows
    (`shard_rows`), the loss is normalised by the whole frame's pixels and
    all-reduced with the gradients; `axis` must name one of the mesh's axes.
    `param_filter(leaf_name) -> bool` (a leaf name of `scene_leaves`, e.g.
    "sphere_origin" or "lights.position"; the JAX package passes a pytree
    path) freezes the leaves it rejects: their gradients are zeroed."""
    if config.msaa > 1:
        # The train loss is defined on 1-sample soft renders; supersampled
        # training would need the loss averaged over sample offsets.
        raise ValueError(
            "make_train_step does not support msaa > 1; render the target "
            "at msaa=0 or average sample offsets in a custom loss"
        )
    h, w = config.height, config.width
    cam, h_local = camera, h
    if mesh is not None:
        if axis not in mesh.axis_names:
            raise ValueError(f"axis {axis!r} is not an axis of the mesh "
                             f"{mesh.axis_names}")
        n = mesh_n_shards(mesh)
        if h % n:
            raise ValueError(f"height {h} not divisible by mesh size {n}")
        h_local = h // n
        cam = shift_camera_rows(camera, mesh.rank * h_local)
    inv_npix = 1.0 / (h * w * 3.0)
    render = render_soft_pallas if config.backend == "pallas" else render_soft
    local_cfg = config.replace(height=h_local, soft=True,
                               framebuffer_dtype="float")

    def step(state: TrainState, target) -> tuple:
        if tuple(target.shape[:2]) != (h_local, w):
            raise ValueError(f"target {tuple(target.shape)}: this rank's rows "
                             f"are ({h_local}, {w}, 4)")
        leaves = scene_leaves(state.scene)
        img = render(state.scene, cam, local_cfg)
        diff = (img[..., :3] - target[..., :3]) * (1.0 / 255.0)
        loss = torch.sum(diff * diff) * inv_npix
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves.values(), grads)]
        loss = loss.detach()
        if mesh is not None:
            loss, grads = _all_reduce(mesh, loss, grads)
        for (name, p), g in zip(leaves.items(), grads):
            if param_filter is not None and not param_filter(name):
                g = torch.zeros_like(p)
            p.grad = g
        state.opt_state.step()
        return state._replace(step=state.step + 1), loss

    return step


def scene_snapshot(scene) -> Scene:
    """Detached copy of a scene's current values."""
    return dataclasses.replace(
        scene,
        **{k: getattr(scene, k).detach().clone() for k in _SCENE_KEYS},
        lights=Lights(**{k: getattr(scene.lights, k).detach().clone()
                         for k in _LIGHT_KEYS}),
    )
