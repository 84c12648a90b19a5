"""One row-sharded train step on tiny shapes: the port's counterpart of the
JAX package's `__graft_entry__.dryrun_multichip`.

    python -m opencl_ray_tracer_tpu_torch.parallel.dryrun N
    torchrun --nproc_per_node=N -m opencl_ray_tracer_tpu_torch.parallel.dryrun N

The body is the JAX package's: a (2, N/2) (hosts, chips) mesh for even
N >= 4, else the flat one; an (8N, 128) frame, phong with soft shadows,
scene 1, Adam 1e-2, a zero target, one step. Started as a rank of a group
(the variables torchrun sets), the module runs that rank, on its card unless
`--cpu` asks for gloo on the CPU; started alone, `dryrun_multichip(N)` runs
N gloo ranks on this host's CPU.

`--problem PATH [PATH ...]` runs the sharded train step (or `fit_scene`) of
problems saved by `save_problem`, in turn, one rank a process, and writes
each rank's losses and final scene to `PATH.rank<r>.npz`: how a test holds
the ranks against each other and against a one-device run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from opencl_ray_tracer_tpu_torch.parallel import distributed

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def dryrun_body(n_devices: int) -> float:
    """The sharded train step on the n ranks of this process group. Returns
    the (all-reduced) loss."""
    from opencl_ray_tracer_tpu_torch import RenderConfig, create_scene1, legacy_ortho_camera
    from opencl_ray_tracer_tpu_torch.parallel import (
        adam,
        init_train_state,
        make_mesh,
        make_mesh_2d,
        make_train_step,
        replicate,
        shard_rows,
    )

    if n_devices >= 4 and n_devices % 2 == 0:
        mesh = make_mesh_2d(2, n_devices // 2)
    else:
        mesh = make_mesh(n_devices)
    dev = mesh.device or distributed.local_device()
    h, w = 8 * n_devices, 128
    config = RenderConfig(width=w, height=h, shading="phong", shadows=True,
                          soft=True, framebuffer_dtype="float")
    camera = legacy_ortho_camera(device=dev)
    optimizer = adam(1e-2)
    step = make_train_step(camera, config, optimizer, mesh=mesh)
    target = shard_rows(torch.zeros((h, w, 4), dtype=torch.float32, device=dev), mesh)
    state = init_train_state(replicate(create_scene1(device=dev), mesh), optimizer)
    state, loss = step(state, target)
    loss = float(loss)
    if mesh.rank == 0:
        print(f"dryrun_multichip({n_devices}): one sharded train step OK (mesh "
              f"axes {mesh.axis_names}, shape {mesh.shape}, {dev}), loss={loss:.6f}")
    return loss


def run_ranks(n: int, args, timeout: float = 600.0):
    """Run this module with `args` as n gloo ranks on this host's CPU;
    raises if a rank fails. Returns each rank's completed process."""
    env = {"PYTHONPATH": os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p)}
    procs = distributed.launch_local(
        n, [sys.executable, "-m", "opencl_ray_tracer_tpu_torch.parallel.dryrun",
            *map(str, args), "--cpu"], timeout, env)
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {n} failed (rc={p.returncode}):\n"
                               f"{p.stderr[-4000:]}")
    return procs


def dryrun_multichip(n_devices: int) -> None:
    """The dryrun on n ranks: in this process when the group has n ranks
    (or n is 1 and there is no group: this process, on its card), else in n
    gloo CPU processes started here."""
    if distributed.world_size() == n_devices:
        dryrun_body(n_devices)
    elif torch.distributed.is_initialized():
        raise ValueError(f"dryrun_multichip({n_devices}) in a group of "
                         f"{distributed.world_size()} ranks")
    else:
        print(run_ranks(n_devices, [n_devices])[0].stdout.strip())


# -- a saved problem, run over the ranks ------------------------------------

def save_problem(path: str, scene_arrays: dict, target: np.ndarray, config,
                 *, steps: int = 1, learning_rate: float = 1e-2,
                 jit: bool = False, fit: Optional[dict] = None,
                 render=None) -> None:
    """Write a problem for `--problem`: the scene (`scene_to_arrays`), the
    (H, W, 4) target, the config (its mesh_shape picks the mesh), and
    either `steps` train steps at `learning_rate` (the compiled step with
    `jit`) or `fit`, the keywords of `fit_scene` (steps, trainable,
    checkpoint_dir, ...). With `render`, a config whose row-sharded frame
    (`render_sharded` + `gather_rows`) each rank also writes. The camera is
    the legacy ortho one."""
    spec = {"config": config.to_json(), "steps": steps, "lr": learning_rate,
            "jit": jit, "fit": fit,
            "render": render.to_json() if render is not None else None}
    np.savez(path, target=np.asarray(target, np.float32), spec=json.dumps(spec),
             **{f"scene:{k}": v for k, v in scene_arrays.items()})


def run_problem(path: str) -> str:
    """This rank's run of a saved problem; returns the file it wrote."""
    from opencl_ray_tracer_tpu_torch import RenderConfig, legacy_ortho_camera
    from opencl_ray_tracer_tpu_torch.models.inverse import fit_scene
    from opencl_ray_tracer_tpu_torch.parallel import (
        adam,
        gather_rows,
        init_train_state,
        make_train_step,
        mesh_from_config,
        render_sharded,
        replicate,
        scene_leaves,
        shard_rows,
    )
    from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays

    with np.load(path if path.endswith(".npz") else f"{path}.npz") as data:
        spec = json.loads(str(data["spec"]))
        target = data["target"]
        arrays = {k[len("scene:"):]: data[k] for k in data.files
                  if k.startswith("scene:")}
    dev = distributed.local_device()
    scene = scene_from_arrays(arrays, dev)
    config = RenderConfig.from_json(spec["config"])
    camera = legacy_ortho_camera(device=dev)
    mesh = mesh_from_config(config)
    out = {}
    if spec["fit"] is not None:
        fitted, losses = fit_scene(scene, target, camera=camera, config=config,
                                   mesh=mesh, **spec["fit"])
    else:
        optimizer = adam(spec["lr"])
        step = make_train_step(camera, config, optimizer, mesh=mesh,
                               jit=spec.get("jit", False))
        state = init_train_state(replicate(scene, mesh), optimizer)
        target_rows = shard_rows(target, mesh)
        losses = []
        for _ in range(spec["steps"]):
            state, loss = step(state, target_rows)
            losses.append(float(loss))
        fitted = state.scene
    if spec["render"] is not None:
        cfg = RenderConfig.from_json(spec["render"])
        with torch.no_grad():
            out["frame"] = gather_rows(render_sharded(scene, camera, cfg, mesh=mesh),
                                       mesh).cpu().numpy()
    out.update({f"scene:{k}": v.detach().cpu().numpy()
                for k, v in scene_leaves(fitted).items()})
    jax_loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "opencl_ray_tracer_tpu"))
    stem = path[:-len(".npz")] if path.endswith(".npz") else path
    written = f"{stem}.rank{mesh.rank}.npz"
    np.savez(written, losses=np.asarray(losses, np.float64),
             mesh_shape=np.asarray(mesh.shape), rank=mesh.rank,
             jax_modules=json.dumps(jax_loaded), **out)
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="opencl_ray_tracer_tpu_torch.parallel.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="ranks of the dryrun")
    ap.add_argument("--cpu", action="store_true",
                    help="ranks on the CPU over gloo (default: one card a rank, NCCL)")
    ap.add_argument("--problem", nargs="+", default=None,
                    help="run these saved problems, in turn, as one rank of "
                         "the group")
    args = ap.parse_args(argv)
    if args.problem is None and args.n is None:
        ap.error("give N (the ranks of the dryrun) or --problem")
    if "WORLD_SIZE" not in os.environ:
        if args.problem is not None:
            ap.error("--problem runs as a rank: start it with torchrun")
        dryrun_multichip(args.n)
        return 0
    if args.cpu:
        torch.set_num_threads(1)
    distributed.initialize(backend="gloo" if args.cpu else None)
    try:
        if args.problem is not None:
            for path in args.problem:
                run_problem(path)
        else:
            dryrun_body(args.n)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
