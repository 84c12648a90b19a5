"""The row-sharded fit step of `cli fit` under torchrun, four gloo ranks on
this host's CPU, held against the plain reference of the benchmark
(`rtbench/reference/fit.py`, plain torch autograd over the whole frame).

Every rank runs what `models.inverse.fit_scene` runs: `distributed.
initialize`, `make_mesh()`, `replicate`, `shard_rows` and
`make_train_step(..., mesh=mesh, jit=True)` (eager on the CPU, one gloo
all-reduce a step), for two Adam steps from a perturbed scene 3 (its
distributions at 128 x 64: 12 spheres and 4 cubes over the frame). The
losses, the first gradients (Adam's first moment after step 1 over 1 - b1)
and the trained leaves after the steps are compared with the reference's;
then the same ranks run the step with the exchange taken out (each rank
keeps its own rows' loss and gradients), which must fail the comparison.
The ranks run in one module fixture, with a timeout.
"""

import os
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from opencl_ray_tracer_tpu_torch.parallel import distributed  # noqa: E402
from rtbench.lib import scenes  # noqa: E402
from rtbench.reference import fit as ref_fit  # noqa: E402
from rtbench.reference import soft as ref_soft  # noqa: E402

torch.set_num_threads(2)

W, H, RANKS, STEPS, LR, SEED = 128, 64, 4, 2, 0.5, 2 ** 31 + 77
TRAINABLE = ("sphere_origin", "sphere_radius", "sphere_colour")
# scene3_1080's mode, K caps and light; its bounds scaled from 1910 x 1070
# at 1920 x 1080 to this frame
MODE = dict(shading="phong", shadows=True, soft=True, framebuffer_dtype="float",
            tau_depth=1.0, tau_edge=0.5, backend="pallas", cull_k=96,
            shadow_cull_k=136)
SCENE = {"generator": "random_scene", "n_spheres": 12, "n_cubes": 4,
         "bounds": [1910.0 * W / 1920.0, 1070.0 * H / 1080.0],
         "lights": {"position": [[200.0 * W / 1920.0, 100.0 * H / 1080.0, 200.0]],
                    "colour": [[1.0, 1.0, 1.0]], "intensity": [1.0],
                    "ambient": 0.1, "spec_strength": 0.5, "shininess": 32.0},
         "layout_seed": 0}
PERTURB = {"origin_sigma": 20.0 * W / 1920.0, "radius_scale": 0.25,
           "colour_sigma": 0.15}
TIMEOUT = 240

RANK = textwrap.dedent(f"""
    import os, sys
    sys.path.insert(0, {ROOT!r})
    import torch
    torch.set_num_threads(1)
    from opencl_ray_tracer_tpu_torch import RenderConfig, legacy_ortho_camera
    from opencl_ray_tracer_tpu_torch.models.inverse import param_filter_from_names
    from opencl_ray_tracer_tpu_torch.parallel import distributed, mesh as M
    from opencl_ray_tracer_tpu_torch.parallel.train import (
        adam, init_train_state, make_train_step, scene_leaves)
    from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays
    from opencl_ray_tracer_tpu_torch.utils import tracing

    out = sys.argv[1]
    p = torch.load(os.path.join(out, "problem.pt"))
    cpu = torch.device("cpu")
    distributed.initialize(backend="gloo")
    mesh = M.make_mesh()
    target = M.shard_rows(p["target"], mesh)
    cfg = RenderConfig(width={W}, height={H}, **p["mode"]).validate()
    keys = {TRAINABLE!r}

    def fit():
        opt = adam({LR})
        step = make_train_step(legacy_ortho_camera(device=cpu), cfg, opt, mesh=mesh,
                               param_filter=param_filter_from_names(keys), jit=True)
        state = init_train_state(M.replicate(scene_from_arrays(p["start"], cpu), mesh),
                                 opt)
        leaves = scene_leaves(state.scene)
        losses, grad = [], None
        for t in range({STEPS}):
            state, loss = step(state, target)
            losses.append(float(loss))
            if grad is None:
                grad = {{k: state.opt_state.state[leaves[k]]["exp_avg"] / 0.1
                        for k in keys}}
        return {{"losses": losses, "grad": grad,
                 "after": {{k: leaves[k].detach().clone() for k in keys}},
                 "flat_bytes": 4 * (1 + sum(v.numel() for v in leaves.values()))}}

    tracing.reset()
    sound = fit()
    sound["counters"] = {{k: tracing.counter(k) for k in
                          ("mesh.all_reduces", "mesh.all_reduce_bytes")}}
    # the fault: the step with no exchange, each rank on its own rows
    M.Mesh.all_reduce = lambda self, t: t
    fault = fit()
    torch.save({{"sound": sound, "fault": fault}},
               os.path.join(out, f"rank{{distributed.rank()}}.pt"))
""")


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """(each rank's readings, the reference's (losses, first gradients,
    leaves after), the start)."""
    out = tmp_path_factory.mktemp("mesh_fit")
    cpu = torch.device("cpu")
    truth = scenes.make_scene(SCENE, SEED, cpu)
    start = scenes.perturb(truth, PERTURB, SEED + 1)
    cfg = {"height": H, "width": W, **MODE}
    with torch.no_grad():
        target = ref_soft.render(truth, {"kind": "ortho"}, H, W, shading=MODE["shading"],
                                 shadows=MODE["shadows"], tau_d=MODE["tau_depth"],
                                 tau_e=MODE["tau_edge"])
    torch.save({"start": start, "target": target, "mode": MODE}, out / "problem.pt")
    done = distributed.launch_local(RANKS, [sys.executable, "-c", RANK, str(out)],
                                    timeout=TIMEOUT, env={"OMP_NUM_THREADS": "1"})
    for r, p in enumerate(done):
        assert p.returncode == 0, f"rank {r}:\n{p.stderr[-3000:]}"
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(RANKS)]
    ref = ref_fit.adam_steps(start, target, {"kind": "ortho"}, cfg, TRAINABLE, LR, STEPS)
    return ranks, ref, start


def _gaps(got, ref, start):
    """(worst relative loss gap over the steps, worst leaf's first-gradient
    gap, worst leaf's change gap), each as max |a - b| over max |b|."""
    r_losses, r_grad, r_after = ref
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], r_losses))
    grad = max(rel(got["grad"][k], r_grad[k]) for k in TRAINABLE)
    change = max(rel(got["after"][k] - start[k], r_after[k] - start[k])
                 for k in TRAINABLE)
    return loss, grad, change


# Tolerances. At this size no tile's list reaches its K cap and the cull
# leaves out only coverage below float32's resolution, so what is left is
# the order of the sums: the loss, a mean over 24,576 values, moves by ~1e-6
# of itself (read: 8.5e-7); a first gradient, four ranks' partial sums added
# by the all-reduce, by ~1e-4 of its largest element (read: 4.4e-5). Adam's
# step divides by the gradient's own size, so an element whose gradient is
# round-off may step another way: the change after two steps is held at
# 1e-2 of the largest change (read: 6.1e-5). The step without the exchange
# reads 0.80, 1.0 and 1.9.
LOSS_TOL, GRAD_TOL, CHANGE_TOL = 1e-5, 1e-3, 1e-2


def test_the_mesh_fit_matches_the_reference_on_the_whole_frame(fitted):
    ranks, ref, start = fitted
    loss, grad, change = _gaps(ranks[0]["sound"], ref, start)
    assert loss < LOSS_TOL and grad < GRAD_TOL and change < CHANGE_TOL, (loss, grad, change)


def test_every_rank_holds_the_same_reduced_state(fitted):
    ranks, _, _ = fitted
    first = ranks[0]["sound"]
    for other in ranks[1:]:
        assert other["sound"]["losses"] == first["losses"]
        for k in TRAINABLE:
            assert torch.equal(other["sound"]["after"][k], first["after"][k])
            assert torch.equal(other["sound"]["grad"][k], first["grad"][k])


def test_the_step_without_the_exchange_fails_the_comparison(fitted):
    """Each rank keeps its own rows' loss and gradients: rank 0's loss is a
    quarter of the frame's or less, its gradients those of its rows."""
    ranks, ref, start = fitted
    loss, grad, change = _gaps(ranks[0]["fault"], ref, start)
    assert loss > 10 * LOSS_TOL and grad > GRAD_TOL, (loss, grad, change)
    assert ranks[0]["fault"]["losses"] != ranks[1]["fault"]["losses"]


def test_the_counters_count_one_exchange_of_the_flat_buffer_a_step(fitted):
    ranks, _, _ = fitted
    for r in ranks:
        s = r["sound"]
        # the loss and every leaf's gradient, frozen leaves' included
        assert s["counters"] == {"mesh.all_reduces": STEPS,
                                 "mesh.all_reduce_bytes": STEPS * s["flat_bytes"]}
        assert s["flat_bytes"] == 4 * (1 + 12 * (3 + 1 + 4) + 48 * (9 + 4) + 10)
