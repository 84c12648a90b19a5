"""A closed loop of one client re-running the trace of the port's app shell,
`app.MainState`, as `cli app` builds it (`StateManager`, `InputManager`, the
configuration's `RenderConfig`): the reference app at its default, where the
SPACE key re-runs the trace (MainState.cpp:135-239).

The set-up builds the state on the card, whose first update runs the
startup trace, then re-runs it for "warmup_seconds". A unit is the re-run
key ("key") through the manager's event handler and update, which runs
`MainState.run_trace`: the frame, the fence and the frame's copy into the
app's pinned host buffer (`host_framebuffer`). The unit is a frame on the
host, as the reference app's OpenCL time ends with its map of the output
buffer (MainState.cpp:641-934): for an app that keeps the frame on the card
(no `host_framebuffer`), the unit makes the same copy after the update,
into a pinned buffer of its own kept from unit to unit, so that every
program is timed for the same work. The host clock around the unit is the
frame's latency. The state builds scene 1 from its own library
(`scene.library.create_scene1`); the check's reference builds it here, in
plain torch, from the configuration's numbers, so the check holds the
port's library scene to the published one too.

The inputs keep the keys of `frames.py` ("arrays", "cams" with the one
camera, "mode", "frame_keys"), so the frames' metric readers read this loop.
The check compares the host copy of each of "check_frames" units, drawn from
the seed, with `reference.hard` by `frames.mismatch_share`, and each host
copy with the frame on the card, word for word."""

from __future__ import annotations

import math
import time

import torch

from rtbench.lib import files, scenes
from rtbench.reference import hard

frames = files.load("loops", "frames")


def _rotation(rx: float, ry: float, rz: float) -> torch.Tensor:
    """Rz @ Ry @ Rx of one Cube.rotate call (angles in degrees), float32 from
    angles in float64, as the reference's Cube class composes it."""
    m = [scenes._rot(axis, torch.tensor([deg * math.pi / 180.0],
                                        dtype=torch.float64)).float()[0]
         for axis, deg in ((2, rz), (1, ry), (0, rx))]
    return m[0] @ m[1] @ m[2]


def scene_arrays(spec: dict, device) -> dict:
    """The flat arrays of a scene given primitive by primitive (keys
    `scenes.SCENE_KEYS` and "lights.<key>"), float32 on `device`: spheres by
    origin, radius and colour; cubes as the unit cube scaled, rotated call
    by call and translated; "lights" null for none."""
    if spec["generator"] != "scene1":
        raise ValueError(f"unknown scene generator {spec['generator']!r}")
    f32 = dict(dtype=torch.float32)
    unit = torch.tensor(scenes.UNIT_CUBE, **f32)
    verts, colours = [], []
    for c in spec["cubes"]:
        v = unit * c["scale"]
        for rx, ry, rz in c["rotations_degrees"]:
            v = v @ _rotation(rx, ry, rz).T
        verts.append((v + torch.tensor(c["translation"], **f32)).reshape(12, 3, 3))
        colours.append(torch.tensor(c["colour"], **f32).expand(12, 4))
    sph = spec["spheres"]
    out = {
        "sphere_origin": torch.tensor([s["origin"] for s in sph], **f32),
        "sphere_radius": torch.tensor([s["radius"] for s in sph], **f32),
        "sphere_colour": torch.tensor([s["colour"] for s in sph], **f32),
        "tri_verts": torch.cat(verts),
        "tri_colour": torch.cat(colours),
    }
    lights = spec["lights"] or {"position": torch.zeros(0, 3), "colour": torch.zeros(0, 3),
                                "intensity": torch.zeros(0), "ambient": 0.0,
                                "spec_strength": 0.0, "shininess": 0.0}
    for k in scenes.LIGHT_KEYS:
        out[f"lights.{k}"] = torch.as_tensor(lights[k], **f32)
    return {k: v.contiguous().to(device) for k, v in out.items()}


def setup(run):
    from opencl_ray_tracer_tpu_torch import RenderConfig
    from opencl_ray_tracer_tpu_torch.app import InputManager, MainState, StateManager
    from opencl_ray_tracer_tpu_torch.utils import DeltaTime
    from opencl_ray_tracer_tpu_torch.utils.log import set_level

    cfg, tr, dev = run.config, run.traffic, run.device
    mode = cfg["modes"][tr["mode"]]
    set_level("WARNING")  # the app logs one INFO line a trace
    rcfg = RenderConfig(width=cfg["width"], height=cfg["height"], **mode).validate()
    manager = StateManager()
    state = MainState(manager, InputManager(), config=rcfg, device=dev)
    manager.add_state(state)
    dt = DeltaTime()
    key = tr["key"]
    manager.update(dt.update())  # the startup trace
    warm_until = time.perf_counter() + tr["warmup_seconds"]
    while time.perf_counter() < warm_until:
        manager.event_handler(key)
        manager.update(dt.update())
    g = scenes.generator(run.seed, "cpu")
    draw = 360  # the check's units are drawn among the window's first ones
    sample = {0} | {int(i) for i in torch.randperm(draw, generator=g)
                    [: tr["check_frames"] - 1]}
    kept = {}
    by_app = hasattr(state, "host_framebuffer")
    run.inputs.update(arrays=scene_arrays(cfg["scene"], dev), cams=[cfg["camera"]],
                      mode=mode, kept=kept, frame_keys=[], sample_keys=[0],
                      read_back_by="app" if by_app else "loop")
    run.inputs["program"] = (manager, state)
    spans = run.spans
    own = []  # the loop's host buffer where the app has none

    def read_back(fb):
        if not own or own[0].shape != fb.shape or own[0].dtype != fb.dtype:
            own[:] = [torch.empty(fb.shape, dtype=fb.dtype,
                                  pin_memory=fb.device.type == "cuda")]
        return own[0].copy_(fb)

    def unit(i):
        t0 = time.perf_counter()
        with spans("app.update"):
            manager.event_handler(key)
            manager.update(dt.update())
            host = (state.host_framebuffer if by_app
                    else read_back(state.framebuffer))
        lat = time.perf_counter() - t0
        if spans.on:
            run.inputs["frame_keys"].append(0)
        if i in sample:
            kept[i] = (state.framebuffer, host.clone())
        return lat

    return unit


def release(run):
    run.inputs.pop("program", None)


def check(run):
    cfg, mode, kept = run.config, run.inputs["mode"], run.inputs["kept"]
    ref = hard.render(run.inputs["arrays"], run.inputs["cams"][0], cfg["height"],
                      cfg["width"], mode["shading"], mode["shadows"])
    worst = math.inf if not kept else 0.0
    wrong = 0
    for _, (card, host) in sorted(kept.items()):
        card = card.cpu()
        if tuple(host.shape) != (cfg["height"], cfg["width"], 4):
            worst = math.inf
            continue
        wrong += int((host != card).sum())
        worst = max(worst, frames.mismatch_share(hard.pack(host.to(ref.device)), ref))
    run.note(f"frames compared with the reference: {len(kept)}, read back "
             f"by the {run.inputs['read_back_by']}")
    return [("frame_mismatch_share", worst, run.limits["frame_mismatch_share"]),
            ("readback_mismatch_words", wrong, run.limits["readback_mismatch_words"])]


def control(run) -> dict:
    """The check's frame number with the reference computed in bfloat16 put
    in the program's place."""
    cfg, mode = run.config, run.inputs["mode"]
    args = (run.inputs["arrays"], run.inputs["cams"][0], cfg["height"],
            cfg["width"], mode["shading"], mode["shadows"])
    low = hard.pack(hard.render(*args, dtype=torch.bfloat16))
    return {"frame_mismatch_share": frames.mismatch_share(low, hard.render(*args))}
