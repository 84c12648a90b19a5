"""Roofline counts: a function of a cell's inputs alone (not of the port's K
caps, tiles or bins), checked by hand on small cases."""

import argparse

import pytest
import torch

from rtbench.lib import bounds, files
from rtbench.lib.main import Run
from rtbench.roofline import counts, peaks


def test_bound_takes_the_larger_time():
    assert peaks.bound_s(67e12, 0) == (1.0, "operations")
    assert peaks.bound_s(0, 3.35e12 * 2) == (2.0, "bytes")


def test_hard_frame_counts_by_hand():
    c = {"pairs": torch.tensor([[2, 0], [1, 0]]), "lit": torch.tensor([[True, False], [True, False]]),
         "occluded": torch.tensor([[True, False], [False, False]])}
    ops, nb = counts.hard_frame(c, n_tris=12, n_spheres=1, n_lights=1, shading="phong",
                                projective=True, out_format="packed")
    t = min(counts.OPS["tri_general"], counts.OPS["sph_general"])
    assert ops == 3 * t + 2 * (counts.OPS["shade_fixed"] + counts.OPS["shade_light"]) \
        + counts.OPS["sh_sph"]
    assert nb == counts.scene_bytes(12, 1, 1) + 4 * 4


def test_soft_step_counts_by_hand():
    c = {"tri": torch.tensor([[1, 0]]), "sph": torch.tensor([[2, 1]]),
         "covered": torch.tensor([[True, False]]),
         "occ_tri": torch.tensor([[3, 0]]), "occ_sph": torch.tensor([[0, 0]])}
    cot = torch.tensor([[True, True]])
    (o4, b4), (o5, b5) = counts.soft_step(c, cot, n_tris=12, n_spheres=2, n_lights=1,
                                          projective=False)
    O, B = counts.OPS, counts.OPS_BWD
    prim = lambda T, nt, ns: nt * T["soft_tri_affine"] + ns * T["soft_sph_affine"]  # noqa: E731
    rest = lambda T, occ: T["soft_finish"] + T["soft_light"] + occ * T["occ_tri"]  # noqa: E731
    assert o4 == prim(O, 1, 2) + rest(O, 3) + prim(O, 0, 1)
    assert o5 == (prim(O, 1, 2) + rest(O, 3) + prim(B, 1, 2) + rest(B, 3)
                  + prim(O, 0, 1) + prim(B, 0, 1))
    assert b4 == counts.scene_bytes(12, 2, 1) + 2 * 16


def _run(workload, small, **caps):
    over = small[workload]
    cfg = files.config(files.benchmark(), files.cell(files.benchmark(), workload)["config"])
    mode_name = files.traffic(files.cell(files.benchmark(), workload)["traffic"])["mode"]
    modes = {mode_name: {**cfg["modes"][mode_name], **caps}}
    over = {**over, "config": {**over["config"], "modes": modes}}
    args = argparse.Namespace(workload=workload, seed=99, seconds=0.0, trace=0)
    run = Run(args, files.benchmark(), torch.device("cpu"), over)
    files.load("loops", run.traffic["loop"]).setup(run)
    return run


@pytest.mark.parametrize("caps", [{"cull_k": 8, "shadow_cull_k": 8},
                                  {"cull_k": 64, "shadow_cull_k": 128}])
def test_counts_do_not_follow_the_k_caps(small, caps):
    """The same inputs at the configuration's caps and at other caps give
    the same bounds: the counts read no bins."""
    base = _run("rt10_1080.fit", small)
    other = _run("rt10_1080.fit", small, **caps)
    assert other.config["modes"]["soft"]["cull_k"] == caps["cull_k"]
    assert bounds.soft_step(base) == bounds.soft_step(other)
    fbase = _run("rt10_1080.fly", small)
    fother = _run("rt10_1080.fly", small, **caps)
    for r in (fbase, fother):
        r.inputs["frame_keys"] = [0, 3, 7]
    assert bounds.hard_frames(fbase) == bounds.hard_frames(fother)
    assert all(s > 0 for s, _ in bounds.hard_frames(fbase))
