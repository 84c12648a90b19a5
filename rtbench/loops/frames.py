"""A closed loop of one client rendering frames through the port's facade,
`models.renderer.render`, each fenced before the next is issued: the
interactive app and the flythrough at animation rates.

The traffic file gives the camera path, an orbit of a pinhole camera about
a centre ("orbit": centre, radius, height offset, fov, frames a turn; the
seed picks the start), the configuration's render mode ("mode"), the
set-up's warm-up (frames of the path for "warmup_seconds") and how many
frames the check compares ("check_frames", drawn from the seed among the
first turn). The
check renders each of those cameras with `reference.hard` and counts the
pixels whose RGB differs by more than one level, over the pixels lit in
either frame."""

from __future__ import annotations

import math
import time

import torch

from rtbench.lib import scenes
from rtbench.reference import hard


def orbit_cameras(orbit: dict, width: int, height: int) -> list:
    """The camera parameters of the turn's frames, in angle order."""
    cx, cy, cz = orbit["centre"]
    n = orbit["frames_per_turn"]
    out = []
    for k in range(n):
        a = 2.0 * math.pi * k / n
        out.append({"kind": "pinhole",
                    "position": (cx + orbit["radius"] * math.sin(a),
                                 cy + orbit["height_offset"],
                                 cz + orbit["radius"] * math.cos(a)),
                    "look_at": (cx, cy, cz), "up": (0.0, 1.0, 0.0),
                    "fov_degrees": orbit["fov_degrees"],
                    "width": width, "height": height})
    return out


def frame_order(orbit: dict, start: int):
    """Frame i's index into the turn's cameras."""
    return lambda i: (start + i) % orbit["frames_per_turn"]


def setup(run):
    from opencl_ray_tracer_tpu_torch import RenderConfig, pinhole_camera
    from opencl_ray_tracer_tpu_torch.models.renderer import render
    from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays

    cfg, tr, dev = run.config, run.traffic, run.device
    mode = cfg["modes"][tr["mode"]]
    w, h = cfg["width"], cfg["height"]
    arrays = scenes.make_scene(cfg["scene"], run.seed, dev)
    scene = scene_from_arrays(arrays, dev)
    rcfg = RenderConfig(width=w, height=h, **mode).validate()
    cams = orbit_cameras(tr["orbit"], w, h)
    g = scenes.generator(run.seed, "cpu")
    n_turn = tr["orbit"]["frames_per_turn"]
    start = int(torch.randint(n_turn, (1,), generator=g))
    order = frame_order(tr["orbit"], start)
    sample = {0} | {int(i) for i in torch.randperm(n_turn, generator=g)
                    [: tr["check_frames"] - 1]}
    program_cams = [pinhole_camera(position=c["position"], look_at=c["look_at"],
                                   up=c["up"], fov_degrees=c["fov_degrees"],
                                   width=w, height=h, device=dev) for c in cams]
    backend = mode.get("backend")
    warm_until = time.perf_counter() + tr["warmup_seconds"]
    i = 0
    while time.perf_counter() < warm_until:
        render(scene, program_cams[order(i)], rcfg, backend=backend)
        run.sync()
        i += 1
    kept = {}
    run.inputs.update(arrays=arrays, cams=cams, order=order, mode=mode,
                      kept=kept, frame_keys=[],
                      sample_keys=[order(i) for i in sorted(sample)])
    spans, sync = run.spans, run.sync
    run.inputs["program"] = (scene, program_cams, rcfg)

    def unit(i):
        k = order(i)
        t0 = time.perf_counter()
        with spans("frame.issue"):
            fb = render(scene, program_cams[k], rcfg, backend=backend)
        with spans("frame.fence"):
            sync()
        lat = time.perf_counter() - t0
        if spans.on:
            run.inputs["frame_keys"].append(k)
        if i in sample:
            kept[i] = (k, fb.clone())
        return lat

    return unit


def release(run):
    run.inputs.pop("program", None)


def mismatch_share(prog_words, ref_rgba) -> float:
    """Pixels whose RGB differs by more than one level, over the pixels lit
    (RGB not all zero) in either frame."""
    a = hard.unpack(prog_words)
    b = hard.unpack(hard.pack(ref_rgba))
    bad = ((a - b).abs() > 1).any(-1)
    lit = (a != 0).any(-1) | (b != 0).any(-1)
    return float(bad.sum()) / max(1.0, float(lit.sum()))


def check(run):
    cfg, mode = run.config, run.inputs["mode"]
    kept = run.inputs["kept"]
    worst = math.inf if not kept else 0.0
    for i, (k, words) in sorted(kept.items()):
        ref = hard.render(run.inputs["arrays"], run.inputs["cams"][k],
                          cfg["height"], cfg["width"], mode["shading"],
                          mode["shadows"])
        if tuple(words.shape) != (cfg["height"], cfg["width"]):
            worst = math.inf
            continue
        worst = max(worst, mismatch_share(words, ref))
    run.note(f"frames compared with the reference: {len(kept)}")
    return [("frame_mismatch_share", worst, run.limits["frame_mismatch_share"])]


def control(run) -> dict:
    """The check's number with the reference computed in bfloat16 put in the
    program's place, on the cameras of the frames the check samples."""
    cfg, mode = run.config, run.inputs["mode"]
    worst = 0.0
    for k in run.inputs["sample_keys"]:
        args = (run.inputs["arrays"], run.inputs["cams"][k], cfg["height"],
                cfg["width"], mode["shading"], mode["shadows"])
        low = hard.pack(hard.render(*args, dtype=torch.bfloat16))
        worst = max(worst, mismatch_share(low, hard.render(*args)))
    return {"frame_mismatch_share": worst}
