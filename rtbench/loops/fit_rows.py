"""The row-sharded fit of `cli fit` under `torchrun --nproc_per_node=<n>`
(`models.inverse.fit_scene` over a mesh): the traffic's "ranks" processes,
one card each; rank r renders and differentiates rows r*H/n to
(r+1)*H/n - 1 through the row-shifted camera; the scene and Adam are
replicated; one all-reduce a step sums the loss and every leaf's gradient
(`parallel.train`), captured in each rank's CUDA graph. The fit's schedule
is `loops/fit.py`'s: the compiled step in fits of `steps_per_fit` steps,
the loss read every `log_every`, the state reset in place between fits.

Rank 0 is the run's own process, on card 0. `setup` makes the scene and
the perturbed start from the seed, builds and loads the kernel library,
and only then starts ranks 1 .. n-1 (`lib/ranks.py`, `rtbench/rank.py`),
which `follow`; while they start, rank 0 renders the target over the
whole frame with the reference. Every rank then makes the calls
`fit_scene` makes (`distributed.initialize`, `make_mesh`, `replicate`,
`shard_rows`, `make_train_step(..., mesh=mesh, jit=True)`), gets rank 0's
target over the process group, and runs the check's first steps. Rank 0
steers the others with one message a block of `log_every` steps (reset
first or not, traced or not), sent before the block's first step, so the
loss read that follows waits on the card as in `loops/fit.py` and no step
adds a wait. In a traced run, at the end of the block before the traced
stretch opens, rank 0 arms the others: they start their profilers and
all meet there, outside the stretch. A window that ends within a block is
finished by `release`, outside the window, so that no rank waits in a
captured all-reduce that the others never join; then each rank reports
its traced stretch (`rank_times`), the ranks exit and the process group
ends.

The check is `loops/fit.py`'s, on rank 0's numbers, which the all-reduce
makes the same on every rank, against the reference over the whole frame,
computed on rank 0's card in blocks of rows."""

from __future__ import annotations

import gc
import json
import os
import sys
import time

import torch

from rtbench.lib import files, ranks, scenes, trace
from rtbench.reference import soft as ref_soft

_fit = files.load("loops", "fit")
# drive() starts its clock a moment before unit 0's: rank 0 arms the ranks
# this much early, and where the stretch then opens a block later they drop
# the profile they started
ARM_EARLY_S = 0.005


class _Rank:
    """A rank's fit, made by the calls `fit_scene` makes; `target` is the
    whole frame, rank 0's, broadcast to the others."""

    def __init__(self, run, start: dict, target, steer):
        import torch.distributed as dist

        from opencl_ray_tracer_tpu_torch import RenderConfig, legacy_ortho_camera
        from opencl_ray_tracer_tpu_torch.models.inverse import param_filter_from_names
        from opencl_ray_tracer_tpu_torch.parallel import distributed
        from opencl_ray_tracer_tpu_torch.parallel.mesh import (
            make_mesh,
            replicate,
            shard_rows,
        )
        from opencl_ray_tracer_tpu_torch.parallel.train import (
            adam,
            init_train_state,
            make_train_step,
            scene_leaves,
        )
        from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays

        tr, dev = run.traffic, run.device
        distributed.initialize(backend="gloo" if dev.type == "cpu" else None)
        steer.join()
        mesh = make_mesh()
        dist.broadcast(target, src=0)
        steer.beat()
        rcfg = RenderConfig(width=run.config["width"], height=run.config["height"],
                            **run.config["modes"][tr["mode"]]).validate()
        opt = adam(tr["learning_rate"])
        scene = replicate(scene_from_arrays(start, dev), mesh)
        self.step_fn = make_train_step(
            legacy_ortho_camera(device=dev), rcfg, opt, mesh=mesh,
            param_filter=param_filter_from_names(tr["trainable"]), jit=True)
        self.state = init_train_state(scene, opt)
        self.rows = shard_rows(target, mesh)
        self.leaves = scene_leaves(self.state.scene)
        with torch.no_grad():
            self.origin = {k: v.detach().clone() for k, v in self.leaves.items()}

    def close(self):
        """Drop the compiled step and its CUDA graph, which holds the NCCL
        communicator, and wait for the card."""
        self.step_fn = self.state = self.leaves = self.origin = None
        gc.collect()
        if self.rows.is_cuda:
            torch.cuda.synchronize(self.rows.device)

    def step(self):
        """One step; its loss (the graph's output on a card)."""
        return self.step_fn(self.state, self.rows)[1]

    def reset(self):
        """The fit's start again, in place: leaves and a fresh Adam state."""
        with torch.no_grad():
            for k, v in self.leaves.items():
                v.copy_(self.origin[k])
            for st in self.state.opt_state.state.values():
                for t in st.values():
                    if isinstance(t, torch.Tensor):
                        t.zero_()


def _schedule(tr) -> tuple:
    """(steps_per_fit, log_every): the messages cover whole blocks of
    log_every steps, so fits and the traced stretch are whole blocks."""
    n_fit, log_every = tr["steps_per_fit"], tr["log_every"]
    if n_fit % log_every or tr["trace_units"] % log_every or tr["trace_align"] % log_every:
        raise ValueError("fit_rows: steps_per_fit, trace_units and trace_align must be "
                         "multiples of log_every")
    return n_fit, log_every


def _start(run) -> tuple:
    truth = scenes.make_scene(run.config["scene"], run.seed, run.device)
    return truth, scenes.perturb(truth, run.traffic["perturb"], run.seed + 1)


def setup(run):
    tr, dev = run.traffic, run.device
    n_fit, log_every = _schedule(tr)
    cfg = _fit._soft_cfg(run)
    t0 = time.perf_counter()
    truth, start = _start(run)
    if dev.type == "cuda":
        from opencl_ray_tracer_tpu_torch.kernels._build import load_library

        load_library()  # built here once, before the other ranks load it
    over = {"config": run.config, "traffic": tr, "limits": run.limits}
    team = ranks.Team(tr["ranks"], ["--workload", run.cell["name"], "--seed",
                                    str(run.seed), "--device", dev.type,
                                    "--overrides", json.dumps(over)])
    run.inputs["team"] = team
    cam = {"kind": "ortho"}
    with torch.no_grad():  # while the other ranks start
        target = ref_soft.render(truth, cam, cfg["height"], cfg["width"],
                                 shading=cfg["shading"], shadows=cfg["shadows"],
                                 tau_d=cfg["tau_depth"], tau_e=cfg["tau_edge"])
    run.sync()
    t1 = time.perf_counter()
    rank = _Rank(run, start, target, team)
    t2 = time.perf_counter()
    losses, first_m = [], None
    for t in range(run.limits["check_steps"]):
        losses.append(float(rank.step()))
        team.beat()
        if t == 0:
            first_m = {k: _fit._first_moment(rank.state.opt_state, rank.leaves[k])
                       for k in tr["trainable"]}
    with torch.no_grad():
        after = {k: rank.leaves[k].detach().clone() for k in tr["trainable"]}
    warm_until = time.perf_counter() + tr["warmup_seconds"]
    while time.perf_counter() < warm_until:
        team.block(log_every, reset=True, traced=False)
        rank.reset()
        for _ in range(log_every):
            rank.step()
        run.sync()
    team.block(0, reset=True, traced=False)
    rank.reset()
    run.sync()
    t3 = time.perf_counter()
    run.note(f"set-up: scene, kernels, {tr['ranks']} ranks started and the target "
             f"{t1 - t0:.3f} s, the ranks joined and the step built {t2 - t1:.3f} s, "
             f"first steps (capture included) and warm-up {t3 - t2:.3f} s")
    left = [0]  # steps of the current block that rank 0 has yet to run
    run.inputs.update(truth=truth, start=start, target=target, cam=cam, cfg=cfg,
                      program=(rank, left), losses=losses,
                      first_grad={k: m / (1.0 - _fit.B1) for k, m in first_m.items()},
                      after=after)
    spans = run.spans
    # drive()'s stretch opens at a multiple of trace_align once half the
    # window has passed; `opened` once it has
    align, half = tr["trace_align"], 0.5 * run.args.seconds
    clock = {"first": None, "armed": None, "opened": False}

    def unit(i):
        if i == 0:
            clock["first"] = time.perf_counter()
        j = i % n_fit
        if i % log_every == 0:
            with spans("ranks.steer"):
                team.block(log_every, reset=j == 0 and i > 0, traced=spans.on)
            if spans.on and not clock["opened"]:
                clock["opened"] = True
                run.note(f"the ranks' profilers started before the traced stretch: "
                         f"{clock['armed'] == i}")
            left[0] = log_every
        if j == 0 and i:
            with spans("fit.reset"):
                rank.reset()
        with spans("step.replay"):
            loss = rank.step()
        left[0] -= 1
        if j % log_every == 0:
            with spans("fit.loss_read"):
                float(loss)
        if (run.args.trace and not clock["opened"] and (i + 1) % align == 0
                and time.perf_counter() >= clock["first"] + half - ARM_EARLY_S):
            team.arm()  # the stretch is to open at the next unit
            clock["armed"] = i + 1
        return None

    return unit


def follow(run, steer) -> None:
    """A rank other than 0: the same fit, stepped as rank 0's messages say;
    armed by rank 0 before the traced stretch, it profiles the stretch's
    blocks as rank 0 does; at the stop, its report (`rank_times` of its
    traced stretch) to rank 0."""
    dev = run.device
    _, start = _start(run)
    target = torch.empty((run.config["height"], run.config["width"], 4),
                         dtype=torch.float32, device=dev)
    rank = _Rank(run, start, target, steer)
    for _ in range(run.limits["check_steps"]):
        float(rank.step())
        steer.beat()
    print(f"rtbench: rank {os.environ.get('RANK')} (pid {os.getpid()}) follows rank 0",
          file=sys.stderr, flush=True)
    live, kept, traced_steps = None, None, 0
    while True:
        op, steps, reset, traced = steer.recv()
        if op == ranks.STOP:
            break
        if op == ranks.ARM:
            run.sync()  # the profiler starts with no step in flight
            live = _profile()
            steer.meet()
            continue
        if live is not None and not traced:
            # the stretch is over, or it opens later than armed: stopped with
            # no step in flight, kept only where it held traced steps
            run.sync()
            live.stop()
            kept, live = (live if traced_steps else None), None
        elif traced and live is None:
            run.sync()  # the stretch opened before this rank was armed
            live = _profile()
        if reset:
            rank.reset()
        for k in range(steps):
            loss = rank.step()
            if k == 0:
                float(loss)
        if traced:
            traced_steps += steps
    run.sync()
    if live is not None:
        live.stop()
        kept = live if traced_steps else None
    rank.close()
    steer.report(rank_times(_reduce(kept, traced_steps)) if kept else None)


def _profile():
    """A started profiler of the host and the card, as drive()'s."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _reduce(prof, steps: int) -> dict:
    """`trace.reduce` over a rank's profile of its traced steps: its device
    operations, the window from the first to the last."""
    from torch.autograd import DeviceType

    ops = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
           for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.name.startswith(("rtbench.", "octrt."))]
    if not ops:
        return {"units": steps, "busy_s": 0.0, "by_name": {}}
    return trace.reduce(ops, [], (min(a for _, a, _ in ops), max(b for _, _, b in ops)),
                        steps)


def rank_times(red):
    """A rank's (own, exchange) device seconds a step of a reduced trace:
    busy (the union of its operations) less its time in NCCL's kernels, and
    that NCCL time (None where it ran no NCCL kernel); None without a
    trace. The all-reduce waits in place for the slowest rank, so the
    slowest rank's NCCL time is the nearest to the exchange alone."""
    if not red or not red["units"]:
        return None
    hits = [s for n, s in red["by_name"].items() if ranks.NCCL_KERNEL.search(n)]
    nccl = sum(hits)
    return ((red["busy_s"] - nccl) / red["units"],
            nccl / red["units"] if hits else None)


def release(run):
    """Finish the window's last block, stop every rank, and keep each rank's
    `rank_times` under "rank_times" (None where untraced)."""
    team = run.inputs.pop("team", None)
    if team is None:
        return
    rank, left = run.inputs.pop("program")
    for _ in range(left[0]):
        rank.step()
    rank.close()
    times = run.inputs["rank_times"] = team.stop(rank_times(run.trace))
    run.note(f"each rank's (own, NCCL) device seconds a traced step: {times}")


def check(run):
    release(run)
    return _fit.check(run)


def _rank0_alone(run) -> tuple:
    """The reference followed as rank 0 follows the fit with the exchange
    taken out: its loss and gradients over its own rows, over the whole
    frame's pixels (a 1/ranks share of those rows' mean); Adam's step is
    the same for gradients so scaled, but for its eps. (losses, first
    gradients, leaves after)."""
    n, h = run.traffic["ranks"], run.inputs["cfg"]["height"]
    losses, first, after = _fit.reference(run, rows=slice(0, h // n))
    return [x / n for x in losses], {k: g / n for k, g in first.items()}, after


def control(run) -> dict:
    """`loops/fit.py`'s control and half-rows fault, and the fault of this
    cell: the step without the all-reduce ("no_allreduce")."""
    release(run)
    out = _fit.control(run)
    ref = run.memo("fit_reference", lambda: _fit.reference(run))
    out["no_allreduce"] = _fit.compare(run, *_rank0_alone(run), ref)
    return out
