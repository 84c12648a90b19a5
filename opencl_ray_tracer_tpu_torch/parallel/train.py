"""Differentiable-rendering train step, on one device.

Fits scene parameters to a target image by gradient descent through the
soft renderer: a soft render (the tiled soft kernels for backend "pallas",
the torch-autograd oracle `diff.render_soft` otherwise), a mean squared
error over the RGB channels in 0..1 units, autograd to every scene leaf,
and an Adam step (`torch.optim.Adam` with optax.adam's defaults: b1 0.9,
b2 0.999, eps 1e-8 — the same update formula).

The JAX package runs this step as one program over a device mesh (image
rows sharded, scene gradients all-reduced); the port's multi-GPU version
is ROADMAP A9. A step updates the scene's leaf tensors in place.
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


def make_train_step(
    camera: Camera,
    config: RenderConfig,
    mesh=None,
    param_filter: Optional[Callable[[str], bool]] = None,
) -> Callable:
    """Build the train step: step(state, target (H, W, 4) float32) ->
    (state, loss). `param_filter(leaf_name) -> bool` freezes the leaves it
    rejects (their gradients are zeroed)."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step runs on one device; the mesh (row-sharded) "
            "train step is not ported yet (ROADMAP A9)"
        )
    if config.msaa > 1:
        # The train loss is defined on 1-sample soft renders; supersampled
        # training would need the loss averaged over sample offsets.
        raise ValueError(
            "make_train_step does not support msaa > 1; render the target "
            "at msaa=0 or average sample offsets in a custom loss"
        )
    h, w = config.height, config.width
    inv_npix = 1.0 / (h * w * 3.0)
    use_pallas = config.backend == "pallas"
    local_cfg = config.replace(soft=True, framebuffer_dtype="float")

    def local_loss(scene, target):
        render = render_soft_pallas if use_pallas else render_soft
        img = render(scene, camera, local_cfg)
        diff = (img[..., :3] - target[..., :3]) * (1.0 / 255.0)
        return torch.sum(diff * diff) * inv_npix

    def step(state: TrainState, target) -> tuple:
        leaves = scene_leaves(state.scene)
        loss = local_loss(state.scene, target)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        for (name, p), g in zip(leaves.items(), grads):
            if g is None or (param_filter is not None and not param_filter(name)):
                g = torch.zeros_like(p)
            p.grad = g
        state.opt_state.step()
        return state._replace(step=state.step + 1), loss.detach()

    return step


def scene_snapshot(scene) -> Scene:
    """Detached copy of a scene's current values."""
    return dataclasses.replace(
        scene,
        **{k: getattr(scene, k).detach().clone() for k in _SCENE_KEYS},
        lights=Lights(**{k: getattr(scene.lights, k).detach().clone()
                         for k in _LIGHT_KEYS}),
    )
