#!/usr/bin/env python3
"""Replays of the compiled path on one NVIDIA card, for whichever
`opencl_ray_tracer_tpu_torch` is first on PYTHONPATH:

    PYTHONPATH=. python scripts/torch_replay_times.py [--bench]

The four cases of `chip_smoke.py` phase 16 (c), built the same way: the
640x480 frame of `entry()` (scene 1, phong + shadows, packed), the 1080p
headline frame (`random_scene(10, 1, seed=0)`, phong + shadows, packed) and
the 1080p dynamic frame (the same scene through a pinhole camera), both
through `render_jit` at the K caps the eager path ends at, and the
train1080 step (`make_train_step(jit=True)`, phong + soft shadows, Adam).
Each row holds the eager call's and the replay's per-call median [min, max]
ms (CUDA events around each call), device operations a call and device ms a
call (torch.profiler over 10 calls: the union of the operations' intervals)
and the card's busy share of the wall time. `--bench` also runs the
package's bench (`--skip-context --skip-scaling`) as a subprocess and
prints its four `*_graph_us` slopes. One JSON object per line on stdout,
each with the card's name and power limit.

To compare two commits, unpack the other tree into a directory
(`git archive <commit> opencl_ray_tracer_tpu_torch | tar -x -C <dir>`) and
run the script once per tree in turns on one card (other, this, this,
other): the timing helpers are always those of the tree this script lies
in, so both trees are timed by the same code.
"""

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

import torch

import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu_torch.entry import entry
from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
from opencl_ray_tracer_tpu_torch.models.renderer import render_jit
from opencl_ray_tracer_tpu_torch.parallel.train import (
    adam,
    init_train_state,
    make_train_step,
)

_OWN = pathlib.Path(__file__).resolve().parents[1] / "opencl_ray_tracer_tpu_torch"


def _own(name, rel):
    spec = importlib.util.spec_from_file_location(name, _OWN / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_bench_util = _own("_own_bench_util", "bench_util.py")
_profiling = _own("_own_profiling", "utils/profiling.py")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def say(**kw):
    print(json.dumps(kw), flush=True)


def measure(fn, n_time):
    ms = _bench_util.median_spread(_bench_util.call_times_ms(fn, n_time, 3))
    ops, busy, dev_ms, _ = _profiling.device_profile(fn, 10)
    return dict(ms=ms, device_ops=ops, busy_share=busy, device_ms=dev_ms)


def cases(dev):
    w, h = 1920, 1080
    ortho = T.legacy_ortho_camera(device=dev)
    pin = T.pinhole_camera((w / 2.0, h / 2.0, 900.0), (w / 2.0, h / 2.0, -85.0),
                           fov_degrees=60.0, width=w, height=h, device=dev)
    headline = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
    hl_cfg = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                            framebuffer_dtype="packed")
    fwd_e, (e_scene, e_cam) = entry()
    e_cfg = T.RenderConfig(width=640, height=480, shading="phong", shadows=True,
                           framebuffer_dtype="packed")
    for label, scene, cam, cfg, fn in (
            ("entry 640x480 scene1", e_scene, e_cam, e_cfg, fwd_e),
            ("headline 1080p packed", headline, ortho, hl_cfg, None),
            ("dynamic 1080p pinhole", headline, pin, hl_cfg, None)):
        packed = scene.pack()
        bins = fwd_tiled.bin_for_config(packed, cam, cfg)
        if fn is None:
            cfg = cfg.replace(cull_k=max(bins.k_tri, bins.k_sph),
                              shadow_cull_k=max(bins.k_sh_tri, bins.k_sh_sph, 8))
            fn = render_jit(cfg)
        yield (label,
               lambda s=scene, c=cam, f=cfg: fwd_tiled.render_tiled_packed(
                   s.pack(), c, f),
               lambda fn=fn, s=scene, c=cam: fn(s, c), 50)
    soft_cfg = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                              soft=True, framebuffer_dtype="float",
                              tau_depth=1.0, tau_edge=0.5)
    target = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
    step_e = make_train_step(ortho, soft_cfg, adam(1e-3))
    step_j = make_train_step(ortho, soft_cfg, adam(1e-3), jit=True)
    state_e = init_train_state(headline, adam(1e-3))
    state_j = init_train_state(headline, adam(1e-3))
    yield ("train1080 step", lambda: step_e(state_e, target),
           lambda: step_j(state_j, target), 50)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", action="store_true",
                    help="also run the bench and print its *_graph_us")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = card()
    tree = str(pathlib.Path(T.__file__).resolve().parent)
    for label, eager_fn, replay_fn, n in cases(dev):
        say(tree=tree, case=label, eager=measure(eager_fn, 20),
            replay=measure(replay_fn, n), card=name)
    if args.bench:
        # from the tree's own directory: `-m` puts the working directory
        # first on sys.path
        out = subprocess.run([sys.executable, "-m", "opencl_ray_tracer_tpu_torch.bench",
                              "--skip-context", "--skip-scaling"],
                             capture_output=True, text=True, check=True,
                             cwd=pathlib.Path(tree).parent).stdout
        res = json.loads(out.strip().splitlines()[-1])
        say(tree=tree, case="bench", card=name,
            **{k: v for k, v in res.items() if k.endswith("_graph_us")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
