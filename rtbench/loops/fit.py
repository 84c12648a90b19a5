"""The inverse-rendering fit of `cli fit` / `fit_scene`: the port's compiled
train step (`parallel.train.make_train_step(..., jit=True)`, Adam), built
once, driven in fits of `steps_per_fit` steps with the loss read every
`log_every`; between fits the state goes back in place to the fit's start
(the perturbed scene and a fresh Adam state), so the work stays the same
across the window.

The target is the true scene (from the seed) rendered soft by the
reference; the start is that scene perturbed by the traffic's rule from
seed + 1. Set-up drives the step through its first steps, as many as the
cell's limits file asks for ("check_steps"; the capture is the first
call), and keeps each step's loss, Adam's first moment after the first
(the first gradient times 1 - b1) and the trained leaves after the last,
then warms up for "warmup_seconds" and resets; the check follows the same steps with
`reference.fit` and compares, leaf by leaf, the norms of the first
gradients and of the leaves' change, and each step's loss."""

from __future__ import annotations

import statistics
import time

import torch

from rtbench.lib import scenes
from rtbench.reference import fit as ref_fit
from rtbench.reference import soft as ref_soft

B1 = 0.9


def _soft_cfg(run) -> dict:
    mode = run.config["modes"][run.traffic["mode"]]
    return {"height": run.config["height"], "width": run.config["width"], **mode}


def setup(run):
    from opencl_ray_tracer_tpu_torch import RenderConfig, legacy_ortho_camera
    from opencl_ray_tracer_tpu_torch.models.inverse import param_filter_from_names
    from opencl_ray_tracer_tpu_torch.parallel.train import (
        adam,
        init_train_state,
        make_train_step,
        scene_leaves,
    )
    from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays

    tr, dev = run.traffic, run.device
    cfg = _soft_cfg(run)
    t0 = time.perf_counter()
    truth = scenes.make_scene(run.config["scene"], run.seed, dev)
    start = scenes.perturb(truth, tr["perturb"], run.seed + 1)
    cam = {"kind": "ortho"}
    with torch.no_grad():
        target = ref_soft.render(truth, cam, cfg["height"], cfg["width"],
                                 shading=cfg["shading"], shadows=cfg["shadows"],
                                 tau_d=cfg["tau_depth"], tau_e=cfg["tau_edge"])
    run.sync()
    t1 = time.perf_counter()
    rcfg = RenderConfig(width=cfg["width"], height=cfg["height"],
                        **run.config["modes"][tr["mode"]]).validate()
    opt = adam(tr["learning_rate"])
    step = make_train_step(legacy_ortho_camera(device=dev), rcfg, opt,
                           param_filter=param_filter_from_names(tr["trainable"]),
                           jit=True)
    state = init_train_state(scene_from_arrays(start, dev), opt)
    leaves = scene_leaves(state.scene)
    with torch.no_grad():
        origin = {k: v.detach().clone() for k, v in leaves.items()}

    def reset():
        with torch.no_grad():
            for k, v in leaves.items():
                v.copy_(origin[k])
            for st in state.opt_state.state.values():
                for t in st.values():
                    if isinstance(t, torch.Tensor):
                        t.zero_()

    t2 = time.perf_counter()
    losses, first_m = [], None
    for t in range(run.limits["check_steps"]):
        _, loss = step(state, target)
        losses.append(float(loss))
        if t == 0:
            first_m = {k: _first_moment(state.opt_state, leaves[k])
                       for k in tr["trainable"]}
    with torch.no_grad():
        after = {k: leaves[k].detach().clone() for k in tr["trainable"]}
    warm_until = time.perf_counter() + tr["warmup_seconds"]
    while time.perf_counter() < warm_until:
        reset()
        for _ in range(tr["log_every"]):
            step(state, target)
        run.sync()
    reset()
    run.sync()
    t3 = time.perf_counter()
    run.note(f"set-up: scene and target {t1 - t0:.3f} s, step built "
             f"{t2 - t1:.3f} s, first steps (capture included) and warm-up "
             f"{t3 - t2:.3f} s")
    run.inputs.update(truth=truth, start=start, target=target, cam=cam, cfg=cfg,
                      program=(step, state), losses=losses,
                      first_grad={k: m / (1.0 - B1) for k, m in first_m.items()},
                      after=after)
    spans, n_fit, log_every = run.spans, tr["steps_per_fit"], tr["log_every"]

    def unit(i):
        j = i % n_fit
        if j == 0 and i:
            with spans("fit.reset"):
                reset()
        with spans("step.replay"):
            _, loss = step(state, target)
        if j % log_every == 0:
            with spans("fit.loss_read"):
                float(loss)
        return None

    return unit


def _first_moment(opt, leaf):
    """Adam's first moment of a leaf (zeros where the optimizer holds no
    state for it: it never stepped)."""
    st = opt.state.get(leaf, {})
    m = st.get("exp_avg")
    return torch.zeros_like(leaf).detach() if m is None else m.detach().clone()


def release(run):
    run.inputs.pop("program", None)


def norm_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and the median
    leaf's. Leaves whose reference norm is under a thousandth of the median
    leaf's are left out (round-off moves them)."""
    nr = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    med = statistics.median(nr.values())
    worst = 0.0
    for k, v in prog.items():
        if nr[k] < 1e-3 * med:
            continue
        npg = float(torch.linalg.vector_norm(v.double()))
        worst = max(worst, abs(npg - nr[k]) / max(nr[k], med, 1e-30))
    return worst


def reference(run, **ref_kw):
    """(losses, first gradients, leaves after the steps) of the reference
    followed for the check's steps from the fit's start; `ref_kw` go to
    `reference.fit.adam_steps` (a lower `dtype`, `rows`)."""
    tr, inp = run.traffic, run.inputs
    return ref_fit.adam_steps(inp["start"], inp["target"], inp["cam"], inp["cfg"],
                              tr["trainable"], tr["learning_rate"],
                              run.limits["check_steps"], **ref_kw)


def compare(run, losses, first_grad, after, ref) -> dict:
    """The numbers compared: each step's loss, the first gradients' and the
    leaves' change's norms, leaf by leaf, against the reference's."""
    r_losses, r_g1, r_after = ref
    start = {k: run.inputs["start"][k] for k in run.traffic["trainable"]}
    return {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                        for a, b in zip(losses, r_losses)),
        "grad_gap": norm_gap(first_grad, r_g1),
        "change_gap": norm_gap({k: after[k] - start[k] for k in start},
                               {k: r_after[k] - start[k] for k in start}),
    }


def check(run):
    inp = run.inputs
    ref = run.memo("fit_reference", lambda: reference(run))
    r = compare(run, inp["losses"], inp["first_grad"], inp["after"], ref)
    run.note(f"losses of the first steps: program {inp['losses']}, "
             f"reference {ref[0]}")
    start = {k: inp["start"][k] for k in run.traffic["trainable"]}
    for k in start:
        nrm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa: E731
        run.note(f"{k}: first gradient norm program {nrm(inp['first_grad'][k]):.9e} "
                 f"reference {nrm(ref[1][k]):.9e}; change norm program "
                 f"{nrm(inp['after'][k] - start[k]):.9e} reference "
                 f"{nrm(ref[2][k] - start[k]):.9e}")
    return [(k, r[k], run.limits[k]) for k in ("loss_gap", "grad_gap", "change_gap")]


def control(run) -> dict:
    """The check's numbers with the reference computed in bfloat16 put in the
    program's place ("control"), and with half of the frame's rows left out
    of the loss, the mean taken over the rest ("half_rows")."""
    ref = run.memo("fit_reference", lambda: reference(run))
    h = run.inputs["cfg"]["height"]
    return {name: compare(run, *reference(run, **kw), ref)
            for name, kw in (("control", {"dtype": torch.bfloat16}),
                             ("half_rows", {"rows": slice(0, h // 2)}))}
