"""The least time of the port's kernels on the inputs a run drove, from
`roofline.counts` over the reference's per-pixel counts: the glue between a
run's inputs and the per-layer roofline readers."""

from __future__ import annotations

import torch

from rtbench.reference import hard, soft
from rtbench.roofline import counts
from rtbench.roofline.peaks import bound_s


def _sizes(arrays):
    return (int(arrays["tri_verts"].shape[0]), int(arrays["sphere_radius"].shape[0]),
            int(arrays["lights.position"].shape[0]))


def hard_frames(run) -> list:
    """[(seconds, bound by)] of B1/B2 for each traced frame."""
    cfg, mode = run.config, run.inputs["mode"]
    n_t, n_s, n_l = _sizes(run.inputs["arrays"])
    cache, out = {}, []
    for k in run.inputs["frame_keys"]:
        if k not in cache:
            cam = run.inputs["cams"][k]
            _, c = hard.render(run.inputs["arrays"], cam, cfg["height"],
                               cfg["width"], mode["shading"], mode["shadows"],
                               with_counts=True)
            ops, nb = counts.hard_frame(
                c, n_tris=n_t, n_spheres=n_s, n_lights=n_l,
                shading=mode["shading"], projective=cam["kind"] == "pinhole",
                out_format=mode["framebuffer_dtype"])
            cache[k] = bound_s(ops, nb)
        out.append(cache[k])
    return out


def soft_step(run):
    """((B4 seconds, by), (B5 seconds, by)) of a fit step at the fit's start,
    the cotangent that of the loss against the target."""
    inp = run.inputs
    cfg = inp["cfg"]
    n_t, n_s, n_l = _sizes(inp["start"])
    with torch.no_grad():
        img, c = soft.render(inp["start"], inp["cam"], cfg["height"], cfg["width"],
                             shading=cfg["shading"], shadows=cfg["shadows"],
                             tau_d=cfg["tau_depth"], tau_e=cfg["tau_edge"],
                             counts=True)
    cot = (img[..., :3] != inp["target"][..., :3]).any(-1)
    (o4, b4), (o5, b5) = counts.soft_step(c, cot, n_tris=n_t, n_spheres=n_s,
                                          n_lights=n_l,
                                          projective=inp["cam"]["kind"] == "pinhole")
    return bound_s(o4, b4), bound_s(o5, b5)
