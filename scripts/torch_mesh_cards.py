#!/usr/bin/env python3
"""The row-sharded path across the cards of one host, one card a rank:

    torchrun --nproc_per_node=4 scripts/torch_mesh_cards.py
    torchrun --nproc_per_node=4 scripts/torch_mesh_cards.py --cpu --width 256 --height 128

(`--cpu`: gloo ranks on the CPU, to rehearse the run without cards; times
then are not a card's.) The bench's 1080p train step (10 spheres + 1 cube,
phong + soft shadows, Adam 1e-3, a zero target) on the flat mesh of every
rank and on the (2, n/2) mesh with its two-level all-reduce: the losses of
3 steps identical across ranks and between the two meshes (rtol 1e-6), and
the first equal to the sum of the same blocks' losses on one card (rank 0,
rtol 1e-6); the compiled step (`make_train_step(..., jit=True)`: the step
and its all-reduce captured in one CUDA graph a rank) from the same start,
its 3 losses within rtol 1e-6 of the eager step's, and on the cards the
device operations of one replay with the NCCL kernels among them (a
profiler trace on every rank; rank 0's reported); per-step CUDA-event
medians of 20 steps of each (each rank's, the slowest reported), the
unsharded step on rank 0 alone, and the all-reduce of the step's gradients
alone. Then the headline frame (phong + hard
shadows, packed words): `render_sharded` + `gather_rows` on every rank
against `render_tiled` of the whole frame on rank 0 (>= 99.5% of words
identical), both timed. Rank 0 prints one JSON line, with each card's
name and power limit from nvidia-smi.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import opencl_ray_tracer_tpu_torch as T  # noqa: E402
from opencl_ray_tracer_tpu_torch.kernels import _build  # noqa: E402
from opencl_ray_tracer_tpu_torch.kernels.fwd_tiled import render_tiled  # noqa: E402
from opencl_ray_tracer_tpu_torch.kernels.soft import render_soft_pallas  # noqa: E402
from opencl_ray_tracer_tpu_torch.parallel import (  # noqa: E402
    adam,
    distributed,
    gather_rows,
    init_train_state,
    make_mesh,
    make_mesh_2d,
    make_train_step,
    render_sharded,
    replicate,
    scene_leaves,
    shard_rows,
    shift_camera_rows,
)


def _times_ms(fn, n, dev):
    """Milliseconds of each of n calls (CUDA events on a card, the host's
    clock on the CPU), after one untimed call."""
    import time

    fn()
    out = []
    for _ in range(n):
        if dev.type == "cuda":
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def _slowest(ms, dev):
    """The largest per-rank median, and every rank's."""
    t = torch.tensor([statistics.median(ms)], dtype=torch.float64, device=dev)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    per_rank = [p.item() for p in parts]
    return max(per_rank), per_rank


def _replay_kernels(fn):
    """(device operations in one call of fn, the NCCL kernels among them by
    name), from a torch.profiler trace of that call on this rank's card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(names), sorted({n for n in names if "nccl" in n.lower()})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args()
    distributed.initialize(backend="gloo" if args.cpu else None)
    try:
        run(args)
    finally:
        dist.destroy_process_group()


def run(args) -> None:
    dev = distributed.local_device()
    n, rank = dist.get_world_size(), dist.get_rank()
    w, h = args.width, args.height
    if not args.cpu:
        if rank == 0:
            _build.build()
        dist.barrier()
        _build.load_library()
    smi = (subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
        if not args.cpu else ["cpu"])
    scene = T.random_scene(10, 1, seed=0, bounds=(w - 10.0, h - 10.0), device=dev)
    cam = T.legacy_ortho_camera(device=dev)
    soft = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                          soft=True, framebuffer_dtype="float", tau_depth=1.0,
                          tau_edge=0.5)
    target = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
    out = {"ranks": n, "devices": smi, "frame": [w, h]}

    meshes = {"flat": make_mesh(n)}
    if n >= 4 and n % 2 == 0:
        meshes["2x%d" % (n // 2)] = make_mesh_2d(2, n // 2)
    losses = {}
    for name, mesh in meshes.items():
        opt = adam(1e-3)
        step = make_train_step(cam, soft, opt, mesh=mesh)
        state = init_train_state(replicate(scene, mesh), opt)
        tgt = shard_rows(target, mesh)
        losses[name] = [step(state, tgt)[1].item() for _ in range(3)]
        mine = torch.tensor(losses[name], dtype=torch.float64, device=dev)
        parts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(parts, mine)
        if not all(torch.equal(p, mine) for p in parts):
            raise RuntimeError(f"{name}: the ranks' losses differ: {parts}")
        ms, per_rank = _slowest(_times_ms(lambda: step(state, tgt), 20, dev), dev)
        leaves = scene_leaves(state.scene).values()
        buf = torch.zeros(sum(v.numel() for v in leaves) + 1, device=dev)
        ar, _ = _slowest(_times_ms(lambda: mesh.all_reduce(buf), 100, dev), dev)
        # the compiled step (jit=True): the all-reduce inside its CUDA graph
        opt_j = adam(1e-3)
        step_j = make_train_step(cam, soft, opt_j, mesh=mesh, jit=True)
        state_j = init_train_state(replicate(scene, mesh), opt_j)
        jit_losses = [step_j(state_j, tgt)[1].item() for _ in range(3)]
        rel = max(abs(a - b) / abs(a) for a, b in zip(losses[name], jit_losses))
        if rel > 1e-6:
            raise RuntimeError(f"{name}: the compiled step's losses {jit_losses} "
                               f"are not the eager step's {losses[name]}")
        jms, jper_rank = _slowest(_times_ms(lambda: step_j(state_j, tgt), 20, dev),
                                  dev)
        if not args.cpu:
            replay_ops, nccl_kernels = _replay_kernels(lambda: step_j(state_j, tgt))
            if not nccl_kernels:
                raise RuntimeError(f"{name}: no NCCL kernel in a replay of the "
                                   "compiled step")
        out[name] = {"losses": losses[name], "step_ms": ms,
                     "step_ms_per_rank": per_rank, "all_reduce_ms": ar,
                     "all_reduce_floats": buf.numel(), "jit_losses": jit_losses,
                     "jit_step_ms": jms, "jit_step_ms_per_rank": jper_rank}
        if not args.cpu:
            out[name].update(jit_replay_device_ops=replay_ops,
                             jit_replay_nccl_kernels=nccl_kernels)
    first = list(losses.values())
    for other in first[1:]:
        rel = max(abs(a - b) / abs(a) for a, b in zip(first[0], other))
        if rel > 1e-6:
            raise RuntimeError(f"the meshes' losses differ by {rel}: {losses}")

    hl = h // n
    if rank == 0:
        # the same blocks on one card: the sum of their losses, and the
        # unsharded step alone
        inv = 1.0 / (h * w * 3.0)
        with torch.no_grad():
            blocks = sum(
                ((render_soft_pallas(scene, shift_camera_rows(cam, r * hl),
                                     soft.replace(height=hl))[..., :3] / 255.0) ** 2
                 ).sum().item() * inv for r in range(n))
        rel = abs(blocks - losses["flat"][0]) / abs(blocks)
        if rel > 1e-6:
            raise RuntimeError(f"the flat mesh's loss {losses['flat'][0]} is not "
                               f"the blocks' on one card {blocks}")
        opt = adam(1e-3)
        step1 = make_train_step(cam, soft, opt)
        state1 = init_train_state(scene, opt)
        ms1 = _times_ms(lambda: step1(state1, target), 20, dev)
        out["one_card"] = {"blocks_loss": blocks,
                           "unsharded_step_ms": statistics.median(ms1)}
    dist.barrier()

    hard = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                          framebuffer_dtype="packed")
    mesh = meshes["flat"]
    frame = gather_rows(render_sharded(scene, cam, hard, mesh=mesh), mesh)
    sh_ms, _ = _slowest(_times_ms(
        lambda: gather_rows(render_sharded(scene, cam, hard, mesh=mesh), mesh), 20,
        dev), dev)
    out["frame_sharded_ms"] = sh_ms
    if rank == 0:
        whole = render_tiled(scene, cam, hard)
        same = (frame == whole).float().mean().item()
        if same < 0.995:
            raise RuntimeError(f"the gathered frame: {same} of words identical")
        out["frame_words_identical"] = same
        out["frame_unsharded_ms"] = statistics.median(
            _times_ms(lambda: render_tiled(scene, cam, hard), 20, dev))
        print(json.dumps(out))
    dist.barrier()


if __name__ == "__main__":
    main()
