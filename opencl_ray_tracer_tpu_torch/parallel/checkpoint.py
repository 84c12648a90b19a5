"""Checkpoint / resume of a TrainState: the scene leaves, the optimizer's
state_dict and the step, in one `torch.save` file per checkpoint
(`<dir>/step_<8 digits>.pt`). Long inverse-rendering fits are real
training runs; a killed run resumes from the latest checkpoint.

Over a mesh the state is replicated: rank 0 writes, every rank waits at a
barrier until the file is there, and every rank resumes from the same
file."""

from __future__ import annotations

import os
from typing import Optional

import torch

from opencl_ray_tracer_tpu_torch.parallel.mesh import Mesh
from opencl_ray_tracer_tpu_torch.parallel.train import TrainState, scene_leaves
from opencl_ray_tracer_tpu_torch.utils.log import log_info


def save_checkpoint(path: str, state: TrainState, step: Optional[int] = None,
                    mesh: Optional[Mesh] = None) -> str:
    """Save a TrainState (on a mesh: rank 0 writes, every rank waits for
    it). Returns the checkpoint path."""
    step = int(state.step) if step is None else step
    p = os.path.join(path, f"step_{step:08d}.pt")
    if mesh is not None and mesh.rank != 0:
        mesh.barrier()
        return p
    os.makedirs(path, exist_ok=True)
    payload = {
        "scene": {k: v.detach().cpu() for k, v in scene_leaves(state.scene).items()},
        "optimizer": state.opt_state.state_dict(),
        "step": step,
    }
    tmp = f"{p}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, p)
    log_info("checkpoint saved to %s", p)
    if mesh is not None:
        mesh.barrier()
    return p


def latest_checkpoint(path: str) -> Optional[str]:
    if not os.path.isdir(path):
        return None
    entries = sorted(e for e in os.listdir(path)
                     if e.startswith("step_") and e.endswith(".pt"))
    return os.path.join(path, entries[-1]) if entries else None


def load_checkpoint(ckpt_path: str, example_state: TrainState) -> TrainState:
    """Restore a TrainState into `example_state`'s scene leaves and
    optimizer, in place; the structure is taken from `example_state`.

    Where the optimizer already holds state (Adam's moments and step count
    once it has stepped), that state is copied into its tensors in place: a
    compiled step (`make_train_step(jit=True)`) holds them by address, and
    its graph then reads the restored values. Before the first step the
    optimizer's own `load_state_dict` makes them."""
    dev = example_state.scene.device
    payload = torch.load(ckpt_path, map_location=dev, weights_only=True)
    with torch.no_grad():
        for k, v in scene_leaves(example_state.scene).items():
            v.copy_(payload["scene"][k])
    opt = example_state.opt_state
    if opt.state:
        _load_optimizer_in_place(opt, payload["optimizer"])
    else:
        opt.load_state_dict(payload["optimizer"])
    return example_state._replace(step=int(payload["step"]))


def _load_optimizer_in_place(opt: torch.optim.Optimizer, saved: dict) -> None:
    """`opt.load_state_dict(saved)` that keeps the optimizer's tensors: the
    saved state of parameter i (in param_groups order, as `state_dict`
    numbers them) is copied into the tensors the optimizer holds for it,
    and each group's options are taken from the saved groups."""
    groups = saved["param_groups"]
    if [len(g["params"]) for g in groups] != [len(g["params"])
                                             for g in opt.param_groups]:
        raise ValueError("the checkpoint's optimizer holds other parameters")
    for group, sg in zip(opt.param_groups, groups):
        group.update({k: v for k, v in sg.items() if k != "params"})
    params = [p for group in opt.param_groups for p in group["params"]]
    with torch.no_grad():
        for i, p in enumerate(params):
            have = opt.state[p]
            for k, v in saved["state"][i].items():
                if isinstance(v, torch.Tensor):
                    have[k].copy_(v)
                else:
                    have[k] = v


def resume_or_init(path: str, init_state: TrainState) -> TrainState:
    """The resume-on-restart entry: latest checkpoint if present, else init."""
    ckpt = latest_checkpoint(path)
    if ckpt is None:
        return init_state
    log_info("resuming from %s", ckpt)
    return load_checkpoint(ckpt, init_state)
