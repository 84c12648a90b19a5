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

`make_train_step(..., jit=True)` is the JAX package's `@jax.jit` step, on
one card or on each rank of a mesh: the soft frame of this rank's rows at
the config's K caps for backend "pallas" (kernels/soft_tiled.py
`_soft_tiled_core`: the brute soft kernels take over on the card where a
tile's list overflows, as under `lax.cond`), the torch-autograd oracle at
fixed temperatures for any other backend (`diff.soft.render_soft_jit`, as
JAX's step renders through `render_soft_jit`), the loss,
`torch.autograd.grad`, the all-reduce over the mesh's NCCL groups and the
Adam update, captured as one CUDA graph at the first call and replayed
after (runtime/graph.py). Every rank warms up, captures and replays in the
same order, so the captured all-reduces meet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from opencl_ray_tracer_tpu_torch.camera import Camera
from opencl_ray_tracer_tpu_torch.config import RenderConfig
from opencl_ray_tracer_tpu_torch.diff.soft import render_soft, render_soft_jit
from opencl_ray_tracer_tpu_torch.kernels.soft import render_soft_pallas
from opencl_ray_tracer_tpu_torch.kernels.soft_tiled import _soft_tiled_core
from opencl_ray_tracer_tpu_torch.parallel.mesh import (
    IMAGE_AXIS,
    Mesh,
    mesh_n_shards,
    shift_camera_rows,
)
from opencl_ray_tracer_tpu_torch.runtime import graph
from opencl_ray_tracer_tpu_torch.scene.scene import Lights, Scene
from opencl_ray_tracer_tpu_torch.utils import tracing

# the train step's capture, as `runtime.graph` names its replays
_STEP_NAME = "train step"

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
    defaults; `capturable` (its step count and bias corrections on the
    card, so that a CUDA graph can hold the update) where the parameters lie
    on a card."""

    def make(params) -> torch.optim.Adam:
        params = list(params)
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8,
                                capturable=any(p.is_cuda for p in params))

    return make


def init_train_state(scene, optimizer: Callable) -> TrainState:
    """`optimizer` builds the optimizer from a list of parameters (e.g.
    `adam(lr)`); its seconds add to the counter `train.optimizer_s`
    (`utils.tracing`: Adam's first construction in a process imports
    torch._dynamo)."""
    scene = trainable_scene(scene)
    t0 = time.perf_counter()
    opt = optimizer(list(scene_leaves(scene).values()))
    tracing.count("train.optimizer_s", time.perf_counter() - t0)
    return TrainState(scene, opt, 0)


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
    jit: bool = False,
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
    path) freezes the leaves it rejects: their gradients are zeroed.

    `jit=True` renders this rank's rows at fixed K caps with no host read
    (`fixed_k_step`), and on a card captures the whole step (forward, loss,
    gradients, all-reduce, Adam update) as one CUDA graph at its first call
    for a state, which later calls replay (see `_jit_step`). The returned
    loss is then the graph's output, which the next step overwrites. On a
    card the mesh's groups must be NCCL: a gloo group cannot take part in a
    CUDA graph, and the step raises rather than run eagerly."""
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
    if jit:
        return _jit_step(cam, config, param_filter, mesh, h_local)
    render = render_soft_pallas if config.backend == "pallas" else render_soft
    local_cfg = config.replace(height=h_local, soft=True,
                               framebuffer_dtype="float")

    def step(state: TrainState, target) -> tuple:
        if tuple(target.shape[:2]) != (h_local, w):
            raise ValueError(f"target {tuple(target.shape)}: this rank's rows "
                             f"are ({h_local}, {w}, 4)")
        img = render(state.scene, cam, local_cfg)
        loss = _descend(state, img, target, config, mesh, param_filter)
        return state._replace(step=state.step + 1), loss

    return step


def _descend(state: TrainState, img, target, config: RenderConfig,
             mesh: Optional[Mesh], param_filter) -> torch.Tensor:
    """The rest of a step after the render of this rank's rows: the loss
    over the whole frame's pixels, `torch.autograd.grad` to every leaf, the
    all-reduce over the mesh, the parameter filter and the optimizer's
    update of the leaves in place. Returns the (reduced) loss."""
    leaves = scene_leaves(state.scene)
    diff = (img[..., :3] - target[..., :3]) * (1.0 / 255.0)
    loss = torch.sum(diff * diff) * (1.0 / (config.height * config.width * 3.0))
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
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
    return loss


def fixed_k_step(state: TrainState, target, camera: Camera,
                 config: RenderConfig, taus, param_filter=None,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One train step with no host read, eagerly: what
    `make_train_step(jit=True)` captures. `camera` is this rank's (shifted
    to its first row on a mesh) and `target` its rows. The frame of those
    rows at fixed temperatures (tau_d, tau_e: `taus`, device scalars):
    `_soft_tiled_core` at the config's K caps for backend "pallas", else
    `render_soft_jit`; the loss over the whole frame's pixels,
    `torch.autograd.grad`, the all-reduce over the mesh, the parameter
    filter and the optimizer's update of the state's leaves in place.
    Returns the loss."""
    h_local, w = int(target.shape[0]), config.width
    if config.backend == "pallas":
        img = _soft_tiled_core(state.scene.pack(), camera, *taus, h_local, w,
                               config.shading, config.shadows, config.cull_k,
                               config.shadow_cull_k)
    else:
        img = render_soft_jit(state.scene, camera, *taus, h_local, w,
                              shading=config.shading, shadows=config.shadows)
    return _descend(state, img, target, config, mesh, param_filter)


def step_taus(config: RenderConfig, device) -> tuple:
    """(tau_d, tau_e) of the config as device scalars for `fixed_k_step`."""
    return tuple(torch.tensor(t, dtype=torch.float32, device=device)
                 for t in (config.tau_depth, config.tau_edge))


def _require_nccl(mesh: Optional[Mesh], device) -> None:
    """A step on a card all-reduces inside its CUDA graph: every group of
    the mesh must be NCCL (a gloo group stages through the host)."""
    if mesh is None or torch.device(device).type != "cuda":
        return
    for group in mesh.reduce_groups:
        backend = dist.get_backend(group)
        if backend != "nccl":
            raise ValueError(
                f"make_train_step(jit=True) on a card all-reduces inside a "
                f"CUDA graph: the mesh's groups must be NCCL, not {backend!r}")


def _jit_step(camera: Camera, config: RenderConfig, param_filter,
              mesh: Optional[Mesh], h: int) -> Callable:
    """`fixed_k_step` as a step(state, target), captured whole on a card.

    The temperatures are device scalars the step owns. On a card, the first
    call for a state runs the step twice on a side stream (the kernels'
    build, the lazily made constants, Adam's state, every NCCL
    communicator's first all-reduce), puts the state back as it was
    (parameters and Adam's moments and count, in place; no collective),
    then captures the step over a static target buffer; every call copies
    its target in and replays the graph. On a mesh every rank does this at
    the same call. CPU tensors run the same step eagerly (over gloo groups
    on a mesh). `camera` is this rank's and `h` its rows."""
    w = config.width
    taus = {}  # device -> (tau_d, tau_e)
    graphs = {}  # id(optimizer) -> (optimizer, graph, target buffer, loss)

    def body(state: TrainState, target) -> torch.Tensor:
        dev = target.device
        if dev not in taus:
            taus[dev] = step_taus(config, dev)
        return fixed_k_step(state, target, camera, config, taus[dev],
                            param_filter, mesh)

    def step(state: TrainState, target) -> tuple:
        if tuple(target.shape[:2]) != (h, w):
            raise ValueError(f"target {tuple(target.shape)}: this rank's rows "
                             f"are ({h}, {w}, 4)")
        if not target.is_cuda:
            return state._replace(step=state.step + 1), body(state, target)
        opt = state.opt_state
        entry = graphs.get(id(opt))
        if entry is None or tuple(entry[2].shape) != tuple(target.shape):
            _require_nccl(mesh, target.device)
            buf = target.detach().clone()
            with torch.cuda.device(buf.device):
                keep = _snapshot(opt)
                graph_, loss = graph.capture(lambda: body(state, buf),
                                             name=_STEP_NAME)
                _restore(opt, keep)
            entry = graphs[id(opt)] = (opt, graph_, buf, loss)
        _, graph_, buf, loss = entry
        with torch.cuda.device(buf.device):
            buf.copy_(target)
            graph.replay(graph_, _STEP_NAME)
        return state._replace(step=state.step + 1), loss

    return step


def _snapshot(opt: torch.optim.Optimizer):
    """Copies of the optimizer's parameters and of its state's tensors (None
    where it has none yet)."""
    params = [p for group in opt.param_groups for p in group["params"]]
    with torch.no_grad():
        return [(p, p.detach().clone(),
                 {k: v.clone() for k, v in opt.state[p].items()
                  if isinstance(v, torch.Tensor)} if p in opt.state else None)
                for p in params]


def _restore(opt: torch.optim.Optimizer, keep) -> None:
    """Parameters and optimizer state back to a `_snapshot`, in place (a
    graph captured in between keeps their addresses); state made since then
    goes back to zeros, Adam's fresh state."""
    with torch.no_grad():
        for p, value, state in keep:
            p.copy_(value)
            for k, v in opt.state.get(p, {}).items():
                if not isinstance(v, torch.Tensor):
                    continue
                if state is None:
                    v.zero_()
                else:
                    v.copy_(state[k])


def scene_snapshot(scene) -> Scene:
    """Detached copy of a scene's current values."""
    return dataclasses.replace(
        scene,
        **{k: getattr(scene, k).detach().clone() for k in _SCENE_KEYS},
        lights=Lights(**{k: getattr(scene.lights, k).detach().clone()
                         for k in _LIGHT_KEYS}),
    )
