#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths — the tiled hard forward frame, the soft
differentiable train step, the brute render path (forward and
differentiable), the row-sharded path, the app shell and the compiled
forms (CUDA graphs) — through the entry points a user calls, and fails
(non-zero exit, no result line) unless every phase passes:

1. device: torch, CUDA and nvcc versions, the card's name and power limit;
2. build: nvcc builds every source in kernels/csrc/ from this checkout,
   one nvcc per source, in parallel;
3. kernel vs plain twin at 640x480: scenes 1-3, legacy/lambert/phong with
   and without shadows, ortho and pinhole cameras, packed/int/float frames;
4. the committed goldens through the kernel at 160x120;
5. the main path at full size: the bench headline frame (10 spheres +
   1 cube, 1920x1080, phong + hard shadows, packed words, legacy ortho
   camera) through models.renderer.render(backend="pallas"), and the
   640x480 scene-1 frame of the JAX package's entry(), each three times
   (eager, captured and replayed, replayed: the same frame bit for bit);
   launch and replay counts (B1's, and the binning and gather kernels'
   of the same frames: at least 6 each, a host launch in every eager
   frame), the replayed frame against the twin, B1 on the same bins and
   the oracle, and CUDA-event timings of the kernel, its
   twin and the whole frame;
6. where the time goes: the frame's stages timed back to back in one loop
   (they add up to the frame), and a device trace of 20 frames for kernels
   per frame and the device's busy share; then B1/B2 on the inputs of
   `scripts/torch_kernel_times.py --kernel B1` (the headline frame packed
   and float, legacy and through a pinhole camera; scene 3 and the entry
   frame at 640x480), each against the twin at the hard bars and its list
   of non-empty tiles, built on the card, against the plain version, then
   its device time per launch beside its bound and its time before the
   redesign;
7. the soft kernels B4 (forward) and B5 (backward) against their plain
   twin at 256x128: two scenes, ortho and pinhole, legacy / lambert /
   lambert + shadows / phong + shadows; images within 0.05/255 on every
   pixel, every scene leaf's gradient within 1e-3 of the twin's normalised
   by its largest (2e-3 pinhole); then 16 pixel-gradient Jacobian rows
   (bench.py:434-460) within 1e-4 of the twin's and of diff.render_soft's;
   then B5's handling of its cotangent: exact zeros for an all-zero one, a
   cotangent on a few scattered pixels and one full 8x4 patch and a dense
   one against the twin's autograd, the list of live patches that the card
   built equal to its plain version each time; then two and three lights
   (the backward's build for a light count read at run time);
8. the soft golden (pallas_soft_scene1_phong) through the kernels;
9. the train path at full size: (a) 10 Adam steps of the bench's 1080p
   phong + soft-shadow train step through make_train_step, step 1's
   gradients held against the twin's, the kernels', twin's and whole
   step's CUDA-event times and a device trace of the step; B5 on the
   step's own cotangent, on zeros and on a dense one, through a pinhole
   camera and on scene 3 (1,300 primitives) at 640x480, each beside its
   bound and the time of the kernel before its redesign; B4 the same way,
   on the train step's tables in the four modes of phase 7, through a
   pinhole camera and on scene 3 at 640x480, each against the twin and
   with its list of non-empty tiles against the plain version; (b) the CLI's
   `fit --scene 1 --steps 60` at 640x480, which must lower the loss and the
   sphere-origin error;
10. the brute hard kernel B3 against its plain twin: scenes 1 and 2 at
   640x480 and scene 3 at 256x128, ortho and pinhole, legacy / lambert +
   shadows / phong + shadows / phong, float and int frames, at the hard
   bars below; then against the tiled kernel B1 and the oracle on the same
   frames (two other formulations of the same tests, where an edge pixel may
   fall on the other side: int frames identical on >= 99.9% of pixels and
   >= 99.9% of the lit pixels within 0.5/255); then 4,800 triangles at
   160x120 against the twin (more geometry than shared memory holds: the
   shadow walk that stages it in pieces);
11. the brute soft kernels B6 (forward) and B7 (backward) against their
   plain twin at 256x128, through _soft_render_core: the scenes, cameras and
   four modes of phase 7; images within 0.05/255 on every pixel; the
   gradient of every leaf (scene, lights, camera, both temperatures) within
   1e-3 of the twin's normalised by its largest (2e-3 pinhole); then
   _soft_render_core against render_soft_tiled (ortho), image within
   0.05/255 and scene-leaf gradients within 1e-3 normalised; then scene 3
   (1,300 primitives, phong + soft shadows); then two and three lights
   (the kernels' builds for a light count read at run time; one light has
   builds of its own); then B7's handling of its cotangent: exact zeros for
   an all-zero one, and a cotangent on a few scattered pixels and one full
   8x4 patch against the twin's autograd, the list of live patches that the
   card built equal to its plain version each time; then 2,600 primitives
   at 64x32 against the twin (B7 once held at most 2,400);
12. the brute path at full size: render_pallas_packed on the 1080p headline
   frame (legacy int, the bench's brute row, and phong + shadows float)
   checked against B1's frames; _soft_render_core forward + backward at
   1080p phong + soft shadows, step-1 gradients against the tiled path's
   (within 5e-3 normalised: two paths, see there) and B7 against its twin;
   CUDA-event times of each brute kernel, its twin and the whole calls,
   and the two-count slope beside them; B7 also with a cotangent that is
   non-zero on every pixel and on scene 3 (1,300 primitives) at 256x128, B6
   also on scene 3 at 640x480, B3 also through a pinhole camera and on
   scene 3 at 640x480, each beside its own bound and the time of the
   kernels before their redesign;
   then `python -m opencl_ray_tracer_tpu_torch.bench --skip-scaling` as a
   subprocess, whose exit code, 13 rows (device_ms > 0, the K caps of every
   tiled row; no soft row's lists overflow its caps, so every soft row runs
   the tiled kernels) and JSON keys (shard_map_overhead among them) are
   checked;
13. the configurations new to the card, through their entry points first
   (launches counted): the bench's dynamic frame (the headline frame
   through its pinhole camera, re-binned in the call) against the frame
   with precomputed bins, word for word; B1 on the 1080p stress frame
   (random_scene(100, 100), cull_k=96; legacy packed and phong + shadows
   float) and the 4K frame (1,020 tiles) against the twin on every pixel,
   with the final K caps, the live tiles and the card's tile list; B4 on
   the stress soft frame (cull_k=96, shadow_cull_k=136) within 0.05/255,
   and B5's leaf gradients of its step within 1e-3 normalised of the
   twin's, at 1080p if the twin's autograd fits the card, else the largest
   size that does; render(backend="xla") on the 1080p headline frame
   (phong + shadows float, legacy int) against the oracle and B1, and
   `cli render --backend xla`, whose PNG must be that frame;
14. the row-sharded path (parallel/): a process group of one rank over
   NCCL; the dryrun_multichip body (parallel/dryrun.py) at world size 1
   against the unsharded step; phase 9's 1080p train step on make_mesh(1),
   3 steps, each against the unsharded step from the same state (rtol
   1e-6), both timed, and the all-reduce alone; the headline 1080p frame as 4 blocks of 270 rows and as
   2x2 blocks (render_sharded on each rank's view of a (2, 2) mesh) against
   the unsharded frame (B1 words ortho and pinhole >= 99.5% identical, B2
   >= 99.5% of pixels within 0.5/255, `xla` identical; B4 >= 99.9% of
   pixels within 0.05/255, phase 12's bar for two formulations: the tiled
   soft frame depends on its tile grid), the last block through B2 and
   every block through B4 against their twins, and the 4 blocks' summed
   scene-leaf gradients (B5) within 1e-3 normalised of the same blocks
   through the twin and within 5e-3 of the unsharded ones;
15. the app shell, in this process so that its launches are counted:
   `cli compare` on scenes 1 and 2 at 640x480 legacy and on scene 1 at
   1920x1080 phong + shadows (exit 0 and OK; the CPU leg on the CPU, the
   accelerated leg on the card; both times and the speedup); `cli app
   --keys` over the three backends and scenes 1-3 at 640x480 with a PNG of
   every frame (pallas frames identical to the scene's CPU frame on >
   99.9% of pixels, xla frames on >= 99.9%); the flythrough example at its
   defaults (1280x720, 60 frames, phong + shadows, pinhole; frame 0
   through B2 against the twin, then a frame replayed from the graph the
   demo's loop captured against the twin and B2 on the same bins) and the inverse-rendering example at its
   defaults (the loss falls; B4 and B5 launched: at the compiled step's
   warm-up and capture, its replays uncounted); the memory report shows
   bytes in use on the card and the platform report names it;
16. the compiled path (`graph_phase`): the JAX package's `jit` forms as
   CUDA graphs. `entry()`, the 1080p headline frame (packed and float) and
   the dynamic pinhole frame through `render_jit`, captured at the first
   call and replayed with the camera moved at each replay, each equal to
   the eager frame word for word; the same frames at cull_k 8, where the
   overflow flag is set and the brute kernel's frame comes out; the soft
   frame at cull_k 8 (the brute soft kernels' branch) against the eager
   brute frame and gradients; five `make_train_step(jit=True)` train1080
   steps against the eager step from the same state (1e-6); each of these
   cases built again in a process of its own, where a profiler trace of
   one replay holds the kernels of the branch of `lax.cond` taken and none
   of the other's (`runtime.graph.cond`: conditional nodes), with its
   device operations and busy ms beside the eager call's; eager and
   replayed times, kernels a call, busy share and the JAX bench's slope.
   Its launches are the `graph` path of every kernel in the `kernels`
   line;
17. the JAX package's last compiled forms (`compiled_forms_phase`): C1 (the
   40-sphere pile at the default caps through `render_soft_pallas` takes
   the brute soft kernels B6/B7, train1080 the tiled ones B4/B5); the
   compiled mesh step over a one-rank NCCL group on `make_mesh(1)` and
   `make_mesh_2d(1, 1)`, its all-reduce inside the CUDA graph, 5 train1080
   steps in lockstep with the eager mesh step (1e-6), a replay traced (the
   NCCL kernel in it) and timed; `render_sharded_jit` (the headline frame
   packed and float word for word / bit for bit with the eager frame, at
   cull_k 8 the brute frame's words; the soft and `xla` blocks); the
   compiled fit (`fit_scene` at 640x480, 20 steps, lockstep with the eager
   step, then resume in place into a captured state against the
   uninterrupted run, 1e-6); `render_xla_jit` at 1080p against eager
   `render_xla` and the `jit=True` step on backend `xla` in lockstep with
   the eager one; the branch trace of phase 16 for the mesh steps, the
   sharded frames (packed, float, cull_k 8, soft) and the fit step. Its
   launches are the `phase 17` path of every kernel;
18. the stored-finals regime of B4 / B5 (`finals_phase`): the main paths
   that take it, counted (the eager stress soft step, the bench's `fwd+bwd
   50 + 4` and `fwd+bwd stress` steps, the compiled stress step); B4's
   finals block against the plain block row by row (train1080 tables and
   stress 1080p, the regime forced at train1080 where the slot count may
   not call for it; every row within 1e-4 normalised, bacc through exp;
   the visibilities exp(logvis) 99.9% within 1e-4 and all within 5e-3: a
   shadow ray starts at the hit point, which each side gives to its last
   bits, and at stress scale a grazing occluder's sigmoids magnify that, to
   1.4e-3 in one visibility while the frames agree within 0.05/255); B5
   reading the block against B5 recomputing (1e-5
   normalised) and exact zeros for an all-zero cotangent; a block
   prefilled with NaN before B4 giving finite gradients within 1e-6 of an
   unfilled one's; phase 7's 16 cases and 16 pixel-gradient rows with the
   regime forced, against the twin and the recompute regime at phase 7's
   bars; the compiled stress
   step (K 96 / 136, tiled branch, and K 32 / 64, where a list overflows
   and the brute branch runs), captured and replayed, in lockstep with the
   eager step (1e-6, the loss and each leaf normalised by its largest, as
   phase 17 reads the fit). Its
   launches are the `phase 18` path of B4 and B5, and those made with a
   finals block are `finals_launches_by_path` (eager, bench, compiled);
19. the binning and gather kernels (`bin_phase`, kernels/csrc/bin_tiled.cu)
   on the bench's headline scene at 1920x1080 (10 spheres + 1 cube, phong
   + hard shadows) through the legacy ortho camera and four pinhole
   cameras of an orbit about it, against their twins on the CPU: the lists,
   counts and overflow flag equal, the rows copied from the scene and the
   params equal, shadow planes, normals and the coefficient tables within
   rtol 1e-5 / atol 1e-4, and the frame B1 draws from the tables within
   the hard bars of B1 on the twin's; the counters `launch.bin` and
   `launch.gather`; each wrapper's device time a call (bin: two launches,
   gather: one) beside its twin's on the card and its bound (the bytes of
   the scene and lists read and the tables written once). Then the soft
   frame's binning kernels (`soft_tiled._bin_soft`: bin_soft_prep_kernel +
   bin_soft_tiles_kernel) at the rt10_1080 fit's frame and scene 3's at
   1080p, ortho, tau_edge 0.5: every list, mask, count and the overflow flag
   equal to `_bin_soft_plain`'s on the same tensors, the device time a call
   behind a spin beside the twin's, and the counter `launch.bin_soft` over
   five compiled train steps (the capture's two warm-up runs; replays
   launch nothing from the host). Its rows in the `kernels` line are
   `bin_tiled`, `gather_tiled` and `bin_soft`. Between the two, B1 where
   its warps cull the pinhole shadow rows: scene 3 (1,300 primitives)
   through an orbit camera at 1920x1080, phong + hard shadows, packed, K
   256 / 512, against `_tiled_kernel_plain` (the whole walk) at the hard
   bars, with `b1.shadow_rows` > 0 and the kept share inside (0, 100) from
   that launch, and B1's device time beside the twin's: `pinhole_cull` in
   the `fwd_tiled` row of the `kernels` line;

Hard kernel vs twin is bounded on every pixel: float frames within 0.5/255,
packed and int frames within one step of 1/255 (and identical on >= 99.5%
of pixels).

The second-to-last stdout line is {"kernels": [...]}: per kernel (B1 and its
float output B2 as two entries) its launches on its main paths (per path in
`launches_by_path`), its error against the twin, its time (ms: per
call with the wrapper, or, where `ms_is` says so, device time per launch
behind a spin), the twin's (plain_ms), and bound_ms, the least time the
card could take for the same work: the larger of the bytes it must move
(each input read once, each output written once) over the card's memory
rate and the operations these inputs need over its peak float32 rate (the
counts and bounds of opencl_ray_tracer_tpu_torch/utils/profiling.py: a soft
pixel that no primitive covers needs no shading, a pixel whose cotangent is
zero needs no backward, and the tiled soft kernels need neither the rows nor
the cotangent of an empty tile). A launch of soft_brute_fwd / soft_brute_bwd is one
call of its wrapper, which also launches its small row kernels. No single PyTorch call
computes any of these functions, so library_ms is null. The last line is
{"ok": true, "device": {...}}. Needs no network and imports no JAX.
"""

import copy
import json
import os
import statistics
import subprocess
import sys
import time


def _hard_launches(tracing):
    """B1/B2 runs counted since the last reset: launches from the host, and
    replays of `render_tiled`'s frame graphs, each of which runs B1/B2 once
    on the card."""
    return tracing.counter("launch.B1") + tracing.counter("graph.replays.render_tiled")


def _table_launches(tracing, which):
    """Runs of the binning ("bin") or gather ("gather") kernels of the hard
    frame counted since the last reset, as `_hard_launches` counts B1: host
    launches, and replays of `render_tiled`'s frame graphs, each of which
    bins and gathers once on the card."""
    return (tracing.counter(f"launch.{which}")
            + tracing.counter("graph.replays.render_tiled"))


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _time_ms(fn, n, warmup=3):
    """Median, min, max milliseconds per call over n calls (CUDA events
    around each call; the host's own stalls inside the call count)."""
    from opencl_ray_tracer_tpu_torch.bench_util import call_times_ms, median_spread

    return median_spread(call_times_ms(fn, n, warmup))


BACKGROUND = -16777216  # 0xFF000000 as int32: opaque black, no hit

def _errors(got, want, fmt):
    """Per-pixel error, the largest over the four channels: bytes for
    packed words, values (0-255 scale) for int and float frames."""
    import torch

    if fmt == "packed":
        got = got.view(torch.uint8).reshape(*got.shape, 4)
        want = want.view(torch.uint8).reshape(*want.shape, 4)
    return (got.float() - want.float()).abs().amax(dim=-1)


def _check_twin(label, got, want, fmt):
    """Kernel vs its plain twin, bounded on every pixel: float within
    0.5/255, packed and int within one step (a value on a rounding edge may
    round the other way when the two sides differ in the last ulp) and
    identical on >= 99.5% of pixels."""
    err = _errors(got, want, fmt)
    max_err = err.max().item()
    same = (err == 0).float().mean().item()
    print(f"{label} {fmt}: {same:.6f} identical, max err {max_err:.4f}")
    bound_ok = (max_err < 0.5 if fmt == "float" else
                max_err <= 1 and same >= 0.995)
    _require(bound_ok, f"{label} {fmt}: kernel vs twin max err {max_err}, "
                       f"{same} identical")
    return max_err


def _lit_agreement(got, want):
    """Share of the pixels lit in either float frame (not the (0,0,0,255)
    background) on which the two agree within 0.5/255."""
    import torch

    bg = torch.tensor([0.0, 0.0, 0.0, 255.0], device=got.device)
    lit = (got != bg).any(dim=-1) | (want != bg).any(dim=-1)
    ok = _errors(got, want, "float") < 0.5
    return ok[lit].float().mean().item(), lit.float().mean().item()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: this smoke runs on the card")
    if sys.argv[1:2] == ["--branch-case"]:  # one case of _branch_traces
        return branch_case_main(sys.argv[2])

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import opencl_ray_tracer_tpu_torch as T
    from opencl_ray_tracer_tpu_torch.kernels import _build, fwd_tiled
    from opencl_ray_tracer_tpu_torch.models.renderer import render
    from opencl_ray_tracer_tpu_torch.ops.shading import pack_framebuffer_words
    from opencl_ray_tracer_tpu_torch.ref.tracer import _render_oracle
    from opencl_ray_tracer_tpu_torch.utils import pack_rgba, read_png
    from opencl_ray_tracer_tpu_torch.utils import profiling as P
    from opencl_ray_tracer_tpu_torch.utils import tracing

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    kind = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"[device] nvcc: {nvcc}")
    print(f"[device] {kind}; nvidia-smi: {smi}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    print(f"[build] {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {tracing.counter('kernels.build_s')} s)")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # ---- 3. kernel vs plain twin at 640x480 ------------------------------
    w, h = 640, 480
    before = tracing.counter("launch.B1")
    n_cases = 0
    worst = 0.0
    for num in (1, 2, 3):
        scene = T.create_scene(num, seed=0, device=dev)
        packed = scene.pack()
        for cam_kind in ("ortho", "pinhole"):
            cam = (T.legacy_ortho_camera(device=dev) if cam_kind == "ortho" else
                   T.pinhole_camera((320.0, 240.0, 60.0), (320.0, 240.0, -85.0),
                                    fov_degrees=80.0, width=w, height=h,
                                    device=dev))
            for shading, shadows in (("legacy", False), ("lambert", True),
                                     ("phong", True), ("phong", False)):
                cfg = T.RenderConfig(width=w, height=h, shading=shading,
                                     shadows=shadows)
                bins = fwd_tiled.bin_for_config(packed, cam, cfg)
                for fmt in ("packed", "float"):
                    args, kw = fwd_tiled.kernel_inputs(
                        packed, cam, bins, height=h, width=w, shading=shading,
                        shadows=shadows, out_format=fmt)
                    got = fwd_tiled.tiled_kernel(*args, **kw)
                    torch.cuda.synchronize()
                    want = fwd_tiled._tiled_kernel_plain(*args, **kw)
                    pairs = [(fmt, got, want)]
                    if fmt == "float":
                        pairs.append(("int", torch.trunc(got).int(),
                                      torch.trunc(want).int()))
                    for f, a, b in pairs:
                        err = _check_twin(f"[parity] scene{num} {cam_kind} "
                                          f"{shading} shadows={shadows}", a, b, f)
                        n_cases += 1
                        if f == "float":
                            worst = max(worst, err)
    launched = tracing.counter("launch.B1") - before
    _require(launched > 0, "the parity phase launched no kernel")
    print(f"[parity] {n_cases} comparisons, largest float error {worst:.4f} "
          f"(bar < 0.5; packed and int bar <= 1), {launched} kernel launches")

    # ---- 4. goldens through the kernel at 160x120 ------------------------
    gdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "golden")
    gw, gh = 160, 120
    scenes = {n: T.create_scene(n, seed=0, device=dev) for n in (1, 2)}
    for name, num, shading, shadows, cam_kind, bar in (
        ("pallas_scene1_legacy", 1, "legacy", False, "ortho", 0.999),
        ("pallas_scene1_phong", 1, "phong", True, "ortho", 0.999),
        ("pallas_scene1_pinhole", 1, "legacy", False, "pinhole", 0.999),
        ("pallas_scene1_pinhole_phong", 1, "phong", True, "pinhole", 0.999),
        ("scene1_legacy", 1, "legacy", False, "ortho", 0.995),
        ("scene2_legacy", 2, "legacy", False, "ortho", 0.995),
        ("scene1_phong", 1, "phong", True, "ortho", 0.995),
    ):
        cam = (T.legacy_ortho_camera(device=dev) if cam_kind == "ortho" else
               T.pinhole_camera((320.0, 240.0, 60.0), (320.0, 240.0, -85.0),
                                fov_degrees=80.0, width=gw, height=gh,
                                device=dev))
        cfg = T.RenderConfig(width=gw, height=gh, shading=shading,
                             shadows=shadows,
                             framebuffer_dtype="int" if shading == "legacy" else "float")
        got = pack_rgba(fwd_tiled.render_tiled(scenes[num], cam, cfg))
        want = read_png(os.path.join(gdir, f"{name}.png"))
        same = float((got == want).all(axis=-1).mean())
        print(f"[golden] {name}: {same:.6f} identical (bar {bar})")
        _require(same >= bar, f"golden {name} below its bar: {same}")

    # ---- 5. main path at full size ----------------------------------------
    headline = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
    hl_cfg = T.RenderConfig(width=1920, height=1080, shading="phong",
                            shadows=True, framebuffer_dtype="packed")
    ortho = T.legacy_ortho_camera(device=dev)
    entry_scene = T.create_scene1(device=dev)
    entry_cfg = T.RenderConfig(width=640, height=480, shading="phong",
                               shadows=True, framebuffer_dtype="packed")

    # each frame three times: eager (a key's first call), captured and
    # replayed, replayed; the last is the frame held against the twin below
    tracing.reset()
    hl_runs = [render(headline, ortho, hl_cfg, backend="pallas") for _ in range(3)]
    entry_runs = [fwd_tiled.render_tiled(entry_scene, ortho, entry_cfg)
                  for _ in range(3)]
    torch.cuda.synchronize()
    main_launches = _hard_launches(tracing)
    replays = tracing.counter("graph.replays.render_tiled")
    eager = tracing.counter("frame.eager")
    table_launches = {k: _table_launches(tracing, k) for k in ("bin", "gather")}
    print(f"[main] kernel launches in the main-path run: {main_launches}, "
          f"{replays} of them graph replays; frames eager {eager}, replayed "
          f"{tracing.counter('frame.replayed')}; binning and gather runs "
          f"{table_launches} (host launches: bin "
          f"{tracing.counter('launch.bin')}, gather "
          f"{tracing.counter('launch.gather')})")
    _require(main_launches >= 6, "the main path did not go through the kernel")
    for k, n in table_launches.items():
        _require(n >= 6 and eager >= 1 and tracing.counter(f"launch.{k}") >= eager,
                 f"[main] the main path did not bin and gather on the card: "
                 f"{k} {n} runs, {tracing.counter(f'launch.{k}')} host "
                 f"launches over {eager} eager frames")
    _require(replays >= 4 and tracing.counter("frame.replayed") >= 4,
             f"[main] the repeated frames did not replay: {replays} replays")
    for label, runs in (("headline", hl_runs), ("entry", entry_runs)):
        _require(torch.equal(runs[0], runs[2]) and torch.equal(runs[1], runs[2]),
                 f"[main] {label}: the replayed frame is not the eager one")
        _require(runs[1].data_ptr() != runs[2].data_ptr(),
                 f"[main] {label}: two returned frames share memory")
    hl_out, entry_out = hl_runs[-1], entry_runs[-1]

    kernel_rows = []
    for label, scene, cfg, out in (
        ("headline 1920x1080 10sph+1cube phong+shadows packed", headline,
         hl_cfg, hl_out),
        ("entry 640x480 scene1 phong+shadows packed", entry_scene, entry_cfg,
         entry_out),
    ):
        _require(tuple(out.shape) == (cfg.height, cfg.width)
                 and out.dtype == torch.int32, f"{label}: bad frame {out.shape}")
        packed = scene.pack()
        bins = fwd_tiled.bin_for_config(packed, ortho, cfg)
        args, kw = fwd_tiled.kernel_inputs(
            packed, ortho, bins, height=cfg.height, width=cfg.width,
            shading=cfg.shading, shadows=cfg.shadows, out_format="packed")
        twin = fwd_tiled._tiled_kernel_plain(*args, **kw)
        perr = _check_twin(f"[main] {label}: replayed main path vs twin", out,
                           twin, "packed")
        _require(torch.equal(out, fwd_tiled.tiled_kernel(*args, **kw)),
                 f"[main] {label}: the replayed frame is not B1's on the same bins")
        # the same frame as float RGBA: kernel vs twin (max_abs_err), and
        # kernel vs the brute-force oracle (no culling, no tables), which may
        # break a last-bit tie the other way on a few edge pixels
        fargs, fkw = fwd_tiled.kernel_inputs(
            packed, ortho, bins, height=cfg.height, width=cfg.width,
            shading=cfg.shading, shadows=cfg.shadows, out_format="float")
        fk = fwd_tiled.tiled_kernel(*fargs, **fkw)
        _require(bool(torch.isfinite(fk).all()), f"{label}: non-finite pixels")
        ferr = _check_twin(f"[main] {label}: kernel vs twin", fk,
                           fwd_tiled._tiled_kernel_plain(*fargs, **fkw), "float")
        fo = _render_oracle(scene, ortho, cfg.replace(framebuffer_dtype="float"))
        ofrac, lit = _lit_agreement(fk, fo)
        pfrac = (_errors(out, pack_framebuffer_words(fo), "packed") == 0
                 ).float().mean().item()
        print(f"[main] {label}: vs oracle {ofrac:.6f} of the lit pixels "
              f"within 0.5/255 (bar 0.995), packed {pfrac:.6f} of all pixels "
              f"identical; {lit:.4f} of pixels lit")
        _require(ofrac >= 0.995, f"{label}: kernel vs oracle {ofrac}")
        _require(lit > 0.001, f"{label}: empty frame")

        n = 60
        k_ms = _time_ms(lambda: fwd_tiled.tiled_kernel(*args, **kw), n)
        kf_ms = _time_ms(lambda: fwd_tiled.tiled_kernel(*fargs, **fkw), n)
        p_ms = _time_ms(lambda: fwd_tiled._tiled_kernel_plain(*args, **kw), 50)
        pf_ms = _time_ms(lambda: fwd_tiled._tiled_kernel_plain(*fargs, **fkw), 50)
        f_ms = _time_ms(lambda: fwd_tiled.render_tiled(scene, ortho, cfg), n)
        for what, (med, lo, hi) in (("kernel", k_ms),
                                    ("kernel, float output", kf_ms),
                                    ("plain twin", p_ms),
                                    ("plain twin, float output", pf_ms),
                                    ("whole render_tiled", f_ms)):
            print(f"[time] {label}: {what} median {med:.4f} ms "
                  f"[{lo:.4f}, {hi:.4f}] over >= 50 frames; {smi}")
        # B1's bound (packed) and B2's (float) from this frame's data
        bound = P.b1_bound(args, kw)
        fbound = P.b1_bound(fargs, fkw)
        print(f"[bound] {label}: B1 (packed) {bound[2]:.4e} operations, bound "
              f"{bound[0]:.5f} ms by {bound[1]}; B2 (float) bound {fbound[0]:.5f} "
              f"ms by {fbound[1]} ({bound[3]} lit, {bound[4]} occluded pixels)")
        kernel_rows.append(dict(label=label, k_ms=k_ms, kf_ms=kf_ms, p_ms=p_ms,
                                pf_ms=pf_ms, perr=perr, ferr=ferr, bound=bound,
                                fbound=fbound))

    # ---- 6. where the frame's time goes ------------------------------------
    # One loop times the stages of render_tiled back to back with CUDA
    # events, so per frame they add up to the whole; then a device trace of
    # whole frames gives kernels per frame and the device's busy share.
    for label, scene, cfg in (("headline", headline, hl_cfg),
                              ("entry", entry_scene, entry_cfg)):
        stages = ("pack", "bin_for_config", "kernel_inputs", "kernel")
        per = {name: [] for name in stages + ("frame",)}
        for i in range(53):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            packed = scene.pack()
            ev[1].record()
            bins = fwd_tiled.bin_for_config(packed, ortho, cfg)
            ev[2].record()
            args, kw = fwd_tiled.kernel_inputs(
                packed, ortho, bins, height=cfg.height, width=cfg.width,
                shading=cfg.shading, shadows=cfg.shadows,
                out_format=cfg.framebuffer_dtype)
            ev[3].record()
            fwd_tiled.tiled_kernel(*args, **kw)
            ev[4].record()
            ev[4].synchronize()
            if i < 3:  # warm-up
                continue
            for j, name in enumerate(stages):
                per[name].append(ev[j].elapsed_time(ev[j + 1]))
            per["frame"].append(ev[0].elapsed_time(ev[4]))
        parts = "; ".join(
            f"{name} mean {statistics.fmean(v):.4f} median "
            f"{statistics.median(v):.4f}" for name, v in per.items())
        print(f"[stages] {label}, ms over 50 frames: {parts}; {smi}")
        launches, busy, dev_ms, _ = P.device_profile(
            lambda: fwd_tiled.render_tiled(scene, ortho, cfg), 20)
        print(f"[stages] {label}: {launches:.1f} device kernels per frame, "
              f"device busy {busy:.4f} of the wall time ({dev_ms:.4f} ms of "
              f"device work per frame), 20 traced frames; {smi}")

    b1_ms = hard_tiled_redesign(T, dev, smi)    # 6, B1/B2 redesigned
    soft_phase_kernel_vs_twin(T, dev)           # 7
    soft_phase_cotangents(T, dev)               # 7, B5 and its cotangent
    soft_phase_golden(T, dev, gdir)             # 8
    soft_rows = soft_phase_train(T, dev, smi)   # 9 (a)
    soft_phase_cli_fit()                        # 9 (b)
    brute_phase_hard_vs_twin(T, dev)            # 10
    brute_phase_soft_vs_twin(T, dev)            # 11
    brute_rows = brute_phase_full_size(T, dev, smi)  # 12
    new = new_sizes_phase(T, dev, smi)          # 13
    sharded = sharded_phase(T, dev, smi)        # 14
    shell = shell_phase(T, dev, smi)            # 15
    graph, _ = graph_phase(T, dev, smi)         # 16
    compiled = compiled_forms_phase(T, dev, smi)  # 17
    finals, finals_paths = finals_phase(T, dev, smi)  # 18
    bin_rows, cull = bin_phase(T, dev, smi)     # 19
    for row in bin_rows:
        key = row.pop("counter")
        if key not in table_launches:  # the soft binning: phase 19's own paths
            continue
        row["launches_by_path"] = {"phase 5": table_launches[key],
                                   "phase 19": row["launches"]}
        row["launches"] += table_launches[key]
    for i, (row, key) in enumerate(zip(soft_rows, ("B4", "B5"))):
        row["launches_by_path"] = {"phase 9": row["launches"], "phase 13": new[key],
                                   "phase 14": sharded[key], "phase 15": shell[key],
                                   "graph": graph[key], "phase 17": compiled[key],
                                   "phase 18": finals[key]}
        row["launches"] += (new[key] + sharded[key] + shell[key] + graph[key]
                            + compiled[key] + finals[key])
        row["finals_launches_by_path"] = {path: n[i] for path, n in finals_paths.items()}
    for row, key in zip(brute_rows, ("B3", "B6", "B7")):
        row["launches_by_path"] = {"phase 12": row["launches"], "graph": graph[key],
                                   "phase 17": compiled[key]}
        row["launches"] += graph[key] + compiled[key]

    hl = kernel_rows[0]
    print(smi)  # name, power limit exactly as nvidia-smi gives them
    src = "opencl_ray_tracer_tpu_torch/kernels/csrc/fwd_tiled.cu"
    spin = "device time per launch, behind a spin (per call with the wrapper: "
    print(json.dumps({"kernels": [{
        "name": "fwd_tiled",
        "route": "cuda",
        "source": src,
        "replaces": "opencl_ray_tracer_tpu/kernels/fwd_tiled.py:514",
        "launches": (main_launches + new["B1"] + sharded["B1"] + graph["B1"]
                     + compiled["B1"]),
        "launches_by_path": {"phase 5": main_launches, "phase 13": new["B1"],
                             "phase 14": sharded["B1"], "graph": graph["B1"],
                             "phase 17": compiled["B1"]},
        "max_abs_err": hl["perr"],
        "tolerance": "every pixel: packed bytes within 1 of the twin's, "
                     "identical on >= 99.5%",
        "shape": hl["label"],
        "ms": b1_ms["headline 1080p phong+shadows packed"],
        "ms_is": spin + f"median {hl['k_ms'][0]:.4f} ms, the [time] line)",
        "plain_ms": hl["p_ms"][0],
        "bound_ms": hl["bound"][0],
        "bound_by": hl["bound"][1],
        "library_ms": None,
        "pinhole_cull": cull,  # phase 19: scene 3's culled shadow rows
    }, {
        "name": "fwd_tiled (float output)",
        "route": "cuda",
        "source": src,
        "replaces": "opencl_ray_tracer_tpu/kernels/fwd_tiled.py:1358",
        "launches": (new["B2"] + sharded["B2"] + shell["B2"] + graph["B2"]
                     + compiled["B2"]),
        "launches_by_path": {"phase 13": new["B2"], "phase 14": sharded["B2"],
                             "phase 15": shell["B2"], "graph": graph["B2"],
                             "phase 17": compiled["B2"]},
        "max_abs_err": hl["ferr"],
        "tolerance": "every pixel within 0.5/255 of the twin",
        "shape": hl["label"].replace("packed", "float"),
        "ms": b1_ms["headline 1080p phong+shadows float"],
        "ms_is": spin + f"median {hl['kf_ms'][0]:.4f} ms, the [time] line)",
        "plain_ms": hl["pf_ms"][0],
        "bound_ms": hl["fbound"][0],
        "bound_by": hl["fbound"][1],
        "library_ms": None,
    }] + soft_rows + brute_rows + bin_rows}))
    # the smoke drives one card (cuda:0), whatever else is visible
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}))
    return 0


# B1/B2 before their redesign, device ms per launch behind a spin: RECORDED,
# not measured in this run: the `device_ms` column of
# scripts/torch_kernel_times.py --kernel B1 on the earlier tree (one thread a
# pixel, 32 two-row blocks for every tile, rows staged through shared memory
# behind block barriers), on an NVIDIA H100 80GB HBM3 at 700.00 W. They stay
# out of the `kernels` line.
B1_BEFORE = {
    "headline 1080p phong+shadows packed": 0.0166,
    "headline 1080p phong+shadows float": 0.0211,
    "headline 1080p legacy packed": 0.0142,
    "headline 1080p pinhole phong+shadows packed": 0.0189,
    "scene3 640x480 phong+shadows packed": 0.1035,
    "entry 640x480 scene1 phong+shadows packed": 0.0126,
}


def hard_tiled_redesign(T, dev, smi):
    """B1/B2 on the inputs of scripts/torch_kernel_times.py --kernel B1,
    each held against the twin at the hard bars and its list of non-empty
    tiles against the plain version, then its device time per launch behind
    a spin beside its bound and its recorded time before the redesign.
    Returns {input: device ms}."""
    import torch

    from opencl_ray_tracer_tpu_torch.bench_util import back_to_back_ms, device_ms
    from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
    from opencl_ray_tracer_tpu_torch.utils import profiling as P

    ortho = T.legacy_ortho_camera(device=dev)
    pin = T.pinhole_camera((960.0, 540.0, 1100.0), (960.0, 540.0, -60.0),
                           fov_degrees=50.0, width=1920, height=1080, device=dev)
    head = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
    scene3 = T.create_scene(3, seed=0, device=dev)
    entry = T.create_scene1(device=dev)
    frames = {
        "headline 1080p phong+shadows packed": (head, ortho, 1920, 1080, "phong", True, "packed"),
        "headline 1080p phong+shadows float": (head, ortho, 1920, 1080, "phong", True, "float"),
        "headline 1080p legacy packed": (head, ortho, 1920, 1080, "legacy", False, "packed"),
        "headline 1080p pinhole phong+shadows packed": (head, pin, 1920, 1080, "phong", True,
                                                        "packed"),
        "scene3 640x480 phong+shadows packed": (scene3, ortho, 640, 480, "phong", True, "packed"),
        "entry 640x480 scene1 phong+shadows packed": (entry, ortho, 640, 480, "phong", True,
                                                      "packed"),
    }
    ms = {}
    for what, (scene, cam, w, h, shading, shadows, fmt) in frames.items():
        cfg = T.RenderConfig(width=w, height=h, shading=shading, shadows=shadows,
                             framebuffer_dtype=fmt)
        packed = scene.pack()
        bins = fwd_tiled.bin_for_config(packed, cam, cfg)
        args, kw = fwd_tiled.kernel_inputs(packed, cam, bins, height=h, width=w,
                                           shading=shading, shadows=shadows,
                                           out_format=fmt)
        got, tiles = fwd_tiled._tiled_kernel_cuda(*args, **kw)
        want = fwd_tiled._tiled_kernel_plain(*args, **kw)
        _check_twin(f"[redesign] B1/B2 {what}: vs twin", got, want, fmt)
        n_live = _tile_list_vs_plain(f"[redesign] B1/B2 {what}", tiles, args[1])
        run = lambda: fwd_tiled.tiled_kernel(*args, **kw)  # noqa: E731
        n = 50 if w == 1920 else 20
        ms[what], b2b_ms = device_ms(run, n), back_to_back_ms(run, n)
        bound_ms, by, n_ops, lit, occ = P.b1_bound(args, kw)
        before = B1_BEFORE[what]
        print(f"[redesign] B1/B2 {what}: {ms[what]:.4f} ms of device time per "
              f"launch, {b2b_ms:.4f} back to back with the wrapper (measured in this "
              f"run; {n_live} of {args[1].shape[0]} tiles non-empty, the card's list "
              f"equals its plain version); recorded before the redesign {before:.4f} "
              f"ms of device time (recorded / measured = {before / ms[what]:.1f}); "
              f"bound {bound_ms:.5f} ms by {by} "
              f"({n_ops:.4e} operations, {lit} lit, {occ} occluded), "
              f"{ms[what] / bound_ms:.1f}x over it; {smi}")
    return ms


def _tile_list_vs_plain(label, tiles, counts):
    """The list of non-empty tiles that B1/B2 or B4 built on the card, held
    against its plain version (fwd_tiled._live_tiles): the same tiles, in
    any order. Returns their number, read from the kernel's count."""
    import torch

    from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled

    want = fwd_tiled._live_tiles(counts)
    n = int(tiles[0].item())
    _require(n == want.numel() and torch.equal(tiles[2:2 + n].sort().values.long(), want),
             f"{label}: the card lists {n} non-empty tiles, the plain version "
             f"{want.numel()}, or other ones")
    return n


# ---------------------------------------------------------------------------
# The soft differentiable path: B4 (forward) and B5 (backward)
# ---------------------------------------------------------------------------

SOFT_W, SOFT_H = 256, 128
SOFT_PINHOLE = dict(position=(128.0, 64.0, 200.0), look_at=(128.0, 64.0, -60.0),
                    fov_degrees=65.0, width=SOFT_W, height=SOFT_H)
SOFT_MODES = (("legacy", False), ("lambert", False), ("lambert", True),
              ("phong", True))
FWD_BAR = 0.05  # 0..255 units, every pixel


def _soft_cfg(T, w, h, shading, shadows):
    return T.RenderConfig(width=w, height=h, shading=shading, shadows=shadows,
                          soft=True, framebuffer_dtype="float", tau_depth=1.0,
                          tau_edge=0.5)


def _twin_render(scene, cam, cfg):
    """The frame through the kernels' plain twin (autograd-able), on the
    tensors' device: the same bins, tables and params as the kernels."""
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S

    params, taus, tables, counts, kc = S.soft_kernel_inputs(scene.pack(), cam, cfg)
    return S._soft_tiled_plain(params, taus, tables, counts, cfg=kc)


def _leaf_grads(render, scene, cam, cfg, loss_fn):
    import torch

    from opencl_ray_tracer_tpu_torch.parallel.train import (
        scene_leaves,
        trainable_scene,
    )

    s = trainable_scene(scene)
    leaves = scene_leaves(s)
    loss = loss_fn(render(s, cam, cfg))
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), grads)}


def _compare_grads(label, got, want, atol, lost_floor=1e-6):
    """Every leaf: finite; normalised by the twin's largest magnitude within
    atol; non-zero wherever the twin's gradient is above `lost_floor` of
    that magnitude. Returns the largest normalised error.

    The default floor, 1e-6, holds a kernel to its plain twin, the same
    formulation: a zero there is a dropped contribution. Two formulations
    (brute vs tiled, sharded blocks vs the whole frame) pass their own atol:
    where the true value is a sum near zero, one side may leave an exact 0
    and the other a residue (the brute sphere-origin gradient (3, 0) of the
    1080p headline scene read 1.2e-8 to 7.2e-8 over 60 runs, and 0 once,
    where the tiled one read 5.2e-6, above 1e-6 of the largest), which is
    within the atol that the two are already allowed to differ by."""
    import torch

    worst = 0.0
    for k, w in want.items():
        g = got[k]
        _require(bool(torch.isfinite(g).all()), f"{label} {k}: non-finite grad")
        scale = w.abs().max().item()
        if scale == 0.0:
            _require(g.abs().max().item() == 0.0, f"{label} {k}: twin 0, kernel not")
            continue
        err = (g - w).abs().max().item() / scale
        worst = max(worst, err)
        _require(err <= atol, f"{label} {k}: normalised grad error {err} > {atol}")
        lost = ((w.abs() > lost_floor * scale) & (g == 0)).sum().item()
        _require(lost == 0, f"{label} {k}: {lost} zero grads where the twin's is not")
    return worst


def _mean_sq(img):
    return (img[..., :3] ** 2).mean()


def soft_phase_kernel_vs_twin(T, dev):
    """Phase 7: B4/B5 against the twin at 256x128 on the card: the test
    scene and scene 1, ortho and pinhole, four shading modes. Then the 16
    pixel-gradient probes (bench.py:434-460) against the twin and the
    diff.render_soft oracle."""
    import numpy as np
    import torch

    from opencl_ray_tracer_tpu_torch.diff import render_soft
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
    from opencl_ray_tracer_tpu_torch.utils import tracing

    before = (tracing.counter("launch.B4"), tracing.counter("launch.B5"))
    worst_f, worst_g, n = 0.0, 0.0, 0
    for scene_name in ("test", "scene1"):
        scene = (T.random_scene(5, 3, seed=4, bounds=(250.0, 120.0), device=dev)
                 if scene_name == "test" else T.create_scene1(device=dev))
        for cam_kind in ("ortho", "pinhole"):
            cam = (T.legacy_ortho_camera(device=dev) if cam_kind == "ortho"
                   else T.pinhole_camera(**SOFT_PINHOLE, device=dev))
            atol = 1e-3 if cam_kind == "ortho" else 2e-3
            for shading, shadows in SOFT_MODES:
                cfg = _soft_cfg(T, SOFT_W, SOFT_H, shading, shadows)
                label = f"[soft-parity] {scene_name} {cam_kind} {shading} shadows={shadows}"
                with torch.no_grad():
                    got = S.render_soft_tiled(scene, cam, cfg)
                    want = _twin_render(scene, cam, cfg)
                torch.cuda.synchronize()
                ferr = (got - want).abs().max().item()
                _require(bool(torch.isfinite(got).all()), f"{label}: non-finite")
                _require(ferr < FWD_BAR, f"{label}: fwd max err {ferr} >= {FWD_BAR}")
                gk = _leaf_grads(S.render_soft_tiled, scene, cam, cfg, _mean_sq)
                gt = _leaf_grads(_twin_render, scene, cam, cfg, _mean_sq)
                gerr = _compare_grads(label, gk, gt, atol)
                print(f"{label}: fwd max err {ferr:.5f} (bar {FWD_BAR}), leaf grads "
                      f"normalised max err {gerr:.2e} (bar {atol})")
                worst_f, worst_g, n = max(worst_f, ferr), max(worst_g, gerr), n + 1
    launched = (tracing.counter("launch.B4") - before[0],
                tracing.counter("launch.B5") - before[1])
    _require(launched[0] > 0 and launched[1] > 0, f"phase 7 launches {launched}")
    print(f"[soft-parity] {n} cases: fwd max err {worst_f:.5f}, grads {worst_g:.2e}; "
          f"{launched[0]} B4 and {launched[1]} B5 launches")

    # pixel-gradient probes: exact Jacobian rows d(pixel/255)/d(leaves)
    scene = T.create_scene1(device=dev)
    cam = T.legacy_ortho_camera(device=dev)
    cfg = _soft_cfg(T, SOFT_W, SOFT_H, "phong", True)
    renders = {"kernel": S.render_soft_tiled, "twin": _twin_render,
               "oracle": render_soft}
    with torch.no_grad():
        img = (S.render_soft_tiled(scene, cam, cfg)[..., :3] / 255.0).cpu().numpy()
    h_, w_ = SOFT_H, SOFT_W
    edge = (np.abs(np.diff(img, axis=0)).sum(-1)[:, : w_ - 1]
            + np.abs(np.diff(img, axis=1)).sum(-1)[: h_ - 1, :])
    flat = np.argsort(edge.ravel())[-8:]
    probes = [(int(q // (w_ - 1)), int(q % (w_ - 1))) for q in flat]
    rng = np.random.default_rng(7)
    probes += [(int(rng.integers(h_)), int(rng.integers(w_))) for _ in range(8)]
    err_twin = err_oracle = 0.0
    for pi, (yy, xx) in enumerate(probes):
        rows = {}
        for name, fn in renders.items():
            rows[name] = _leaf_grads(
                fn, scene, cam, cfg,
                lambda im, yy=yy, xx=xx, c=pi % 3: im[yy, xx, c] / 255.0)
        for k in rows["kernel"]:
            err_twin = max(err_twin, (rows["kernel"][k] - rows["twin"][k]).abs().max().item())
            err_oracle = max(err_oracle,
                             (rows["kernel"][k] - rows["oracle"][k]).abs().max().item())
    print(f"[soft-probes] 16 pixel-gradient rows, scene 1 phong+shadows "
          f"256x128: kernel vs twin max-abs {err_twin:.3e}, kernel vs "
          f"diff.render_soft {err_oracle:.3e} (bar 1e-4, 0..1 pixel units)")
    _require(err_twin <= 1e-4 and err_oracle <= 1e-4, "pixel-gradient probes over 1e-4")


_SOFT_OPERANDS = ("params", "taus", "tri_t", "tri_alb", "sph_t", "sph_alb",
                  "tsh_t", "ssh_t")


def _soft_operands(scene, cam, cfg):
    """The tiled soft kernels' operands for a frame, detached: (params, taus,
    tables, counts, the kernels' cfg)."""
    import torch

    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S

    with torch.no_grad():
        return S.soft_kernel_inputs(scene.pack(), cam, cfg)


def _b5_live(label, live, g, counts, kc):
    """The list of live patches that B5 built on the card for the cotangent
    g, held against its plain version: the same patches, in any order.
    Returns their number, read from the kernel's counter."""
    import torch

    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S

    want = S._live_patches(g, counts, cfg=kc)
    n = int(live[0].item())
    _require(n == want.numel(), f"{label}: the card lists {n} live patches, the "
                                f"plain version {want.numel()}")
    _require(torch.equal(live[2:2 + n].sort().values.long(), want),
             f"{label}: the card's live patches differ from the plain version's")
    return n


def _b5_vs_twin(label, operands, g, atol=1e-3):
    """B5 on a cotangent g against the twin's autograd on the same operands
    (and its live list against the plain version): the largest error over
    the eight operands, each normalised by its largest."""
    import torch

    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S

    params, taus, tables, counts, kc = operands
    got, live = S._soft_tiled_bwd_cuda(params, taus, tables, counts, g, kc)
    _b5_live(label, live, g, counts, kc)
    leaves = [t.detach().requires_grad_(True) for t in (params, taus) + tuple(tables)]
    out = S._soft_tiled_plain(leaves[0], leaves[1], leaves[2:], counts, cfg=kc)
    want = torch.autograd.grad(out, leaves, g, allow_unused=True)
    want = [torch.zeros_like(t) if w is None else w for t, w in zip(leaves, want)]
    return _compare_grads(label, dict(zip(_SOFT_OPERANDS, got)),
                          dict(zip(_SOFT_OPERANDS, want)), atol)


def _multi_light_scene(T, dev, n_lights):
    """The 256x128 test scene under two or three lights. (The lights stand
    where every leaf's gradient is well conditioned: with the second one at
    (20, 110, 150) the phong frame's d tau_edge cancels to 0.85 beside
    d tau_depth's 36, and the twin's own float32 sum is 3e-3 off its float64
    value there.)"""
    import torch

    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    lights = T.Lights(
        position=f32([[200.0, 100.0, 200.0], [250.0, 10.0, 180.0],
                      [130.0, -40.0, 120.0]][:n_lights]),
        colour=f32([[1.0, 1.0, 1.0], [1.0, 0.6, 0.3],
                    [0.3, 0.5, 1.0]][:n_lights]),
        intensity=f32([1.0, 0.5, 0.5][:n_lights]), ambient=f32(0.1),
        spec_strength=f32(0.5), shininess=f32(32.0))
    return T.random_scene(5, 3, seed=4, bounds=(250.0, 120.0), lights=lights,
                          device=dev)


def soft_phase_cotangents(T, dev):
    """Phase 7, continued: B5 works only where its cotangent is non-zero,
    and has a build of its own for one light."""
    import torch

    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S

    cam = T.legacy_ortho_camera(device=dev)
    scene = T.random_scene(5, 3, seed=4, bounds=(250.0, 120.0), device=dev)
    w, h = 250, 123  # ragged right and bottom tiles
    ops = _soft_operands(scene, cam, _soft_cfg(T, w, h, "phong", True))
    params, taus, tables, counts, kc = ops
    zero_g = torch.zeros((h, w, 4), device=dev)
    zero_g[..., 3] = 1.0  # alpha's cotangent reaches nothing
    zeros, live = S._soft_tiled_bwd_cuda(params, taus, tables, counts, zero_g, kc)
    _require(all(bool((t == 0).all()) for t in zeros) and live[0].item() == 0,
             "[soft-cotangent] B5 with an all-zero cotangent is not exactly zero")
    g = torch.zeros((h, w, 4), device=dev)
    g[3, 5, 1], g[77, 200, 0], g[h - 1, w - 1, 2] = 1.0, -2.0, 0.5
    g[40:44, 96:104, :3] = 0.5  # one whole patch
    err_s = _b5_vs_twin("[soft-cotangent] B5, scattered pixels + one patch", ops, g)
    err_d = _b5_vs_twin("[soft-cotangent] B5, dense cotangent", ops,
                        torch.full((h, w, 4), 1e-3, device=dev))
    print(f"[soft-cotangent] B5 at {w}x{h}: all-zero cotangent -> exact zeros and "
          f"an empty list; 3 scattered pixels + one 8x4 patch vs the twin's "
          f"autograd {err_s:.2e}, dense {err_d:.2e} (bar 0.001); the card's live "
          f"lists equal their plain version")
    # two and three lights: the build that reads the light count at run time
    for n_lights, shading, shadows in ((2, "phong", True), (3, "lambert", True)):
        scene_l = _multi_light_scene(T, dev, n_lights)
        cfg_l = _soft_cfg(T, SOFT_W, SOFT_H, shading, shadows)
        label = (f"[soft-cotangent] test, {n_lights} lights, ortho {shading} "
                 f"shadows={shadows}")
        with torch.no_grad():
            ferr = (S.render_soft_tiled(scene_l, cam, cfg_l)
                    - _twin_render(scene_l, cam, cfg_l)).abs().max().item()
        _require(ferr < FWD_BAR, f"{label}: fwd max err {ferr} >= {FWD_BAR}")
        gk = _leaf_grads(S.render_soft_tiled, scene_l, cam, cfg_l, _mean_sq)
        gt = _leaf_grads(_twin_render, scene_l, cam, cfg_l, _mean_sq)
        gerr = _compare_grads(label, gk, gt, 1e-3)
        _require(bool((gk["lights.position"][n_lights - 1] != 0).any()),
                 f"{label}: the last light's position has no gradient")
        print(f"{label}: fwd max err {ferr:.5f} (bar {FWD_BAR}), leaf grads "
              f"normalised max err {gerr:.2e} (bar 0.001)")


def soft_phase_golden(T, dev, gdir):
    """Phase 8: the soft golden through the kernel (tests/test_golden.py)."""
    from opencl_ray_tracer_tpu_torch.kernels.soft import render_soft_pallas
    from opencl_ray_tracer_tpu_torch.utils import pack_rgba, read_png

    cfg = _soft_cfg(T, 160, 120, "phong", True)
    got = pack_rgba(render_soft_pallas(T.create_scene1(device=dev),
                                       T.legacy_ortho_camera(device=dev), cfg))
    want = read_png(os.path.join(gdir, "pallas_soft_scene1_phong.png"))
    same = float((got == want).all(axis=-1).mean())
    print(f"[golden] pallas_soft_scene1_phong: {same:.6f} identical (bar 0.999)")
    _require(same >= 0.999, f"soft golden below its bar: {same}")


# B4 before its redesign, device ms per launch behind a spin: RECORDED, not
# measured in this run: the `device_ms` column of
# scripts/torch_kernel_times.py --kernel B4 on the earlier tree (one thread a
# pixel, 32 two-row blocks for every tile, rows staged through shared memory
# behind block barriers, every pixel shaded), on an NVIDIA H100 80GB HBM3 at
# 700.00 W. They stay out of the `kernels` line.
B4_BEFORE = {
    "train1080 ortho legacy": 0.0526,
    "train1080 ortho lambert": 0.0632,
    "train1080 ortho lambert+shadows": 0.1001,
    "train1080 ortho phong+shadows": 0.1002,
    "train1080 pinhole phong+shadows": 0.1550,
    "scene3 640x480 phong+shadows": 0.6986,
}


def soft_phase_train(T, dev, smi):
    """Phase 9 (a): the bench's train step (bench.py:149-171, 619-629):
    headline scene, 1920x1080, phong + soft shadows, Adam lr 1e-3, a zero
    target, 10 steps through make_train_step, with step 1's gradients held
    against the twin's; then the stage times and a device trace."""
    import torch

    from opencl_ray_tracer_tpu_torch.bench_util import back_to_back_ms, device_ms
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
    from opencl_ray_tracer_tpu_torch.parallel import (
        adam,
        init_train_state,
        make_train_step,
    )
    from opencl_ray_tracer_tpu_torch.parallel.train import trainable_scene
    from opencl_ray_tracer_tpu_torch.utils import profiling as P
    from opencl_ray_tracer_tpu_torch.utils import tracing

    w, h = 1920, 1080
    scene = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
    cam = T.legacy_ortho_camera(device=dev)
    cfg = _soft_cfg(T, w, h, "phong", True)
    target = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
    inv_npix = 1.0 / (h * w * 3.0)

    def loss_fn(img):
        diff = (img[..., :3] - target[..., :3]) * (1.0 / 255.0)
        return torch.sum(diff * diff) * inv_npix

    # step 1's gradients: kernels vs twin, at the phase-7 bars
    gk = _leaf_grads(S.render_soft_tiled, scene, cam, cfg, loss_fn)
    gt = _leaf_grads(_twin_render, scene, cam, cfg, loss_fn)
    gerr = _compare_grads("[train] step-1 grads", gk, gt, 1e-3)
    with torch.no_grad():
        fimg = S.render_soft_tiled(scene, cam, cfg)
        ferr = (fimg - _twin_render(scene, cam, cfg)).abs().max().item()
    _require(ferr < FWD_BAR, f"[train] 1080p fwd max err {ferr}")
    print(f"[train] 1080p step-1: fwd max err {ferr:.5f} (bar {FWD_BAR}), leaf "
          f"grads normalised max err {gerr:.2e} (bar 1e-3); "
          f"{(fimg[..., :3] > 1.0).any(-1).float().mean().item():.4f} of pixels lit")

    optimizer = adam(1e-3)
    step = make_train_step(cam, cfg, optimizer)
    state = init_train_state(scene, optimizer)
    o0 = state.scene.sphere_origin.detach().clone()
    tracing.reset()
    losses = []
    for _ in range(10):
        state, loss = step(state, target)
        losses.append(float(loss))
    torch.cuda.synchronize()
    launches = (tracing.counter("launch.B4"), tracing.counter("launch.B5"))
    moved = (state.scene.sphere_origin.detach() - o0).abs().max().item()
    print(f"[train] 10 steps: loss {losses[0]:.6f} -> {losses[-1]:.6f}, sphere "
          f"origins moved {moved:.4e}; launches B4 {launches[0]}, B5 {launches[1]}")
    _require(all(map(lambda v: v == v and abs(v) != float("inf"), losses)),
             f"non-finite loss {losses}")
    _require(moved > 0.0, "the scene did not move")
    _require(launches[0] >= 10 and launches[1] >= 10,
             f"the train step did not go through both kernels: {launches}")

    # stage times, CUDA events, >= 20 runs each
    operands = _soft_operands(scene, cam, cfg)
    params, taus, tables, counts, kc = operands
    # the train step's own cotangent, d loss_fn / d img: non-zero where the
    # frame is; beside it a dense one and zeros
    g = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
    g[..., :3] = 2.0 * fimg[..., :3] * (inv_npix / (255.0 * 255.0))
    dense_g = torch.full((h, w, 4), 1e-6, dtype=torch.float32, device=dev)
    zero_g = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
    leaves_in = [t.detach().requires_grad_(True) for t in (params, taus) + tuple(tables)]
    with torch.enable_grad():
        twin_out = S._soft_tiled_plain(leaves_in[0], leaves_in[1], leaves_in[2:],
                                       counts, cfg=kc)

    def twin_fwd():
        with torch.no_grad():
            S._soft_tiled_plain(params, taus, tables, counts, cfg=kc)

    def twin_fwd_bwd():
        with torch.enable_grad():
            lv = [t.detach().requires_grad_(True) for t in (params, taus) + tuple(tables)]
            out = S._soft_tiled_plain(lv[0], lv[1], lv[2:], counts, cfg=kc)
            torch.autograd.grad(out, lv, g, allow_unused=True)

    def twin_bwd():
        torch.autograd.grad(twin_out, leaves_in, g, allow_unused=True,
                            retain_graph=True)

    def whole_fwd_bwd():
        s = trainable_scene(scene)
        loss_fn(S.render_soft_tiled(s, cam, cfg)).backward()

    # B4 and B5 as the step runs them: with a finals block where the bins'
    # slot count calls for the stored regime (`_use_stored_finals`)
    block = S.finals_block(kc, dev) if kc["stored_finals"] else None

    def b4():
        S.soft_tiled_fwd(params, taus, tables, counts, cfg=kc, finals=block)

    def b5():
        S.soft_tiled_bwd(params, taus, tables, counts, g, cfg=kc, finals=block)

    b4()  # the block B5 reads

    fns = {
        "B4 alone": b4,
        "B5 alone": b5,
        "twin forward": twin_fwd,
        "twin backward": twin_bwd,
        "twin forward + backward": twin_fwd_bwd,
        "whole fwd+bwd (render_soft_tiled + backward)": whole_fwd_bwd,
        "whole train step": lambda: step(state, target),
    }
    times = {what: _time_ms(fn, 20, 2) for what, fn in fns.items()}
    for what, (med, lo, hi) in times.items():
        print(f"[time] train 1080p phong+shadows: {what} median {med:.4f} ms "
              f"[{lo:.4f}, {hi:.4f}] over 20 runs; {smi}")
    # a call above also holds the wrapper's host work (checks, allocation,
    # the ctypes call); back to back, the launches overlap it
    for what, fn in (("B4", b4), ("B5", b5)):
        print(f"[time] train 1080p phong+shadows: {what} back to back "
              f"{back_to_back_ms(fn, 100):.4f} ms per launch over 100; {smi}")
    _train_stages(S, state, cam, cfg, loss_fn, smi)
    kernels, busy, dev_ms, top = P.device_profile(lambda: step(state, target), 10)
    print(f"[stages] train step 1080p: {kernels:.1f} device kernels per step, "
          f"device busy {busy:.4f} of the wall time ({dev_ms:.4f} ms of device "
          f"work per step), 10 traced steps; {smi}")
    print("[stages] train step 1080p, device ms per step by kernel: "
          + "; ".join(f"{name} {ms:.4f}" for name, ms in top))

    # bounds from this step's tables and cotangent (`_tiled_soft_bounds`)
    b4_bound, b5_bound, n_live, n_cov, n_cot = P.tiled_soft_bounds(
        scene, cam, cfg, operands, g)
    print(f"[bound] train 1080p: {n_live} pixels in non-empty tiles, {n_cov} "
          f"covered, {n_cot} with a non-zero cotangent; B4 {b4_bound[2]:.4e} "
          f"operations, bound {b4_bound[0]:.5f} ms by {b4_bound[1]}; B5 (the "
          f"step's cotangent) {b5_bound[2]:.4e} operations, bound "
          f"{b5_bound[0]:.5f} ms by {b5_bound[1]}")

    # The redesigned B5 beside its bounds and beside the same inputs through
    # the kernel as it was before (one thread a pixel of every non-empty
    # tile whatever its cotangent, three block reductions a row). Device
    # time, behind a spin: a call of the wrapper now costs the host more than
    # the kernel costs the card. The earlier times are RECORDED, not measured
    # in this run: the `device_ms` column of scripts/torch_kernel_times.py on
    # the earlier tree, on an NVIDIA H100 80GB HBM3 at 700.00 W, old and new
    # trees in turns on one card. They stay out of the `kernels` line.
    pin = T.pinhole_camera((960.0, 540.0, 1100.0), (960.0, 540.0, -60.0),
                           fov_degrees=50.0, width=w, height=h, device=dev)
    scene3 = T.create_scene(3, seed=0, device=dev)
    cfg3 = _soft_cfg(T, 640, 480, "phong", True)
    ops_pin = _soft_operands(scene, pin, cfg)
    ops3 = _soft_operands(scene3, cam, cfg3)

    def loss_cotangent(ops_):
        img = S.soft_tiled_fwd(*ops_[:4], cfg=ops_[4])
        g_ = torch.zeros_like(img)
        g_[..., :3] = 2.0 * img[..., :3] / (255.0 * 255.0 * img.shape[0] * img.shape[1] * 3)
        return g_

    g_pin, g3 = loss_cotangent(ops_pin), loss_cotangent(ops3)
    perr = _b5_vs_twin("[redesign] B5, pinhole 1080p, vs twin", ops_pin, g_pin, 2e-3)
    print(f"[redesign] B5 through a pinhole camera at 1080p vs the twin's autograd "
          f"{perr:.2e} (bar 2e-3)")
    cases = (
        ("B5, the step's cotangent", scene, cam, cfg, operands, g, 0.5175, 50),
        ("B5, all-zero cotangent", scene, cam, cfg, operands, zero_g, 0.5170, 50),
        ("B5, dense cotangent", scene, cam, cfg, operands, dense_g, 0.5181, 50),
        ("B5, pinhole camera, the loss's cotangent", scene, pin, cfg, ops_pin,
         g_pin, 0.8342, 50),
        ("B5, scene 3 640x480, the loss's cotangent", scene3, cam, cfg3, ops3,
         g3, 3.9002, 10),
        ("B5, scene 3 640x480, dense cotangent", scene3, cam, cfg3, ops3,
         torch.full((480, 640, 4), 1e-6, device=dev), 3.8961, 10),
    )
    for what, sc_, cam_, cfg_, ops_, g_, before, n in cases:
        grads, live_ = S._soft_tiled_bwd_cuda(*ops_[:4], g_, ops_[4])
        n_patches = _b5_live(f"[redesign] {what}", live_, g_, ops_[3], ops_[4])
        if what == "B5, all-zero cotangent":
            _require(all(bool((t == 0).all()) for t in grads),
                     "[redesign] B5 with an all-zero cotangent is not exactly zero")
        run = lambda: S.soft_tiled_bwd(*ops_[:4], g_, cfg=ops_[4])  # noqa: E731
        ms, b2b_ms = device_ms(run, n), back_to_back_ms(run, n)
        # the recomputing B5 of that time, and its bound without a block
        lean = ops_[:4] + (dict(ops_[4], stored_finals=False),)
        bound_ms, by, n_ops = P.tiled_soft_bounds(sc_, cam_, cfg_, lean, g_)[1]
        print(f"[redesign] {what}: {ms:.4f} ms of device time per launch, "
              f"{b2b_ms:.4f} back to back with the wrapper (measured in this run; "
              f"{n_patches} live patches, the card's list equals its plain "
              f"version); recorded before the redesign {before:.4f} ms of device "
              f"time (recorded / measured = {before / ms:.1f}); bound "
              f"{bound_ms:.5f} ms by {by} ({n_ops:.4e} operations), "
              f"{ms / bound_ms:.1f}x over it; {smi}")

    soft_tiled_fwd_redesign(scene, cam, pin, cfg, scene3, cfg3, smi)
    b4_ms = device_ms(b4, 20)
    regime = "writing" if block is not None else "without"
    print(f"[time] train 1080p phong+shadows: B4 as the step runs it ({regime} a "
          f"finals block) {b4_ms:.4f} ms of device time per launch, behind a spin; "
          f"{smi}")

    src = "opencl_ray_tracer_tpu_torch/kernels/csrc/soft_tiled.cu"
    shape = "train step 1920x1080 10sph+1cube phong+soft shadows"
    return [
        {"name": "soft_tiled_fwd", "route": "cuda", "source": src,
         "replaces": "opencl_ray_tracer_tpu/kernels/soft_tiled.py:1397",
         "launches": launches[0], "max_abs_err": ferr,
         "tolerance": f"every pixel within {FWD_BAR}/255 of the twin",
         "shape": shape, "ms": b4_ms,
         "ms_is": f"device time per launch ({regime} a finals block, as the step "
                  "runs it), behind a spin (per call with the wrapper: median "
                  f"{times['B4 alone'][0]:.4f} ms, the [time] line)",
         "plain_ms": times["twin forward"][0], "bound_ms": b4_bound[0],
         "bound_by": b4_bound[1], "library_ms": None},
        {"name": "soft_tiled_bwd", "route": "cuda", "source": src,
         "replaces": "opencl_ray_tracer_tpu/kernels/soft_tiled.py:1580",
         "launches": launches[1], "max_abs_err": gerr,
         "tolerance": "every scene-leaf gradient within 1e-3 of the twin's, "
                      "normalised by the twin's largest (max_abs_err is that "
                      "normalised error)",
         "shape": shape + ", the step's own cotangent"
                  + (", reading the finals block" if block is not None else ""),
         "launch_is": "one wrapper call: the kernel that lists the live "
                      "patches, then the pixel kernel",
         "ms": times["B5 alone"][0],
         "plain_ms": times["twin backward"][0], "bound_ms": b5_bound[0],
         "bound_by": b5_bound[1], "library_ms": None},
    ]


def soft_tiled_fwd_redesign(scene, cam, pin, cfg, scene3, cfg3, smi):
    """B4 on the inputs of scripts/torch_kernel_times.py --kernel B4: the
    headline scene's tables at 1080p in the four modes of phase 7 (phong +
    soft shadows is the train step's), through a pinhole camera, and scene 3
    at 640x480; each held against the twin on every pixel and its list of
    non-empty tiles against the plain version, then its device time per
    launch behind a spin beside its bound and its recorded time before the
    redesign (the lean B4 of that time: no finals block, and its bound
    without one)."""
    import torch

    from opencl_ray_tracer_tpu_torch.bench_util import back_to_back_ms, device_ms
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
    from opencl_ray_tracer_tpu_torch.utils import profiling as P

    b4_ms = {}
    b4_cases = [(f"train1080 ortho {sh}{'+shadows' if sd else ''}", scene, cam,
                 cfg.replace(shading=sh, shadows=sd)) for sh, sd in SOFT_MODES]
    b4_cases += [("train1080 pinhole phong+shadows", scene, pin, cfg),
                 ("scene3 640x480 phong+shadows", scene3, cam, cfg3)]
    for what, sc_, cam_, cfg_ in b4_cases:
        ops_ = _soft_operands(sc_, cam_, cfg_)
        got, tiles = S._soft_tiled_fwd_cuda(*ops_[:4], ops_[4])
        with torch.no_grad():
            err = (got - S._soft_tiled_plain(*ops_[:4], cfg=ops_[4])).abs().max().item()
        _require(err < FWD_BAR, f"[redesign] B4 {what}: vs twin {err} >= {FWD_BAR}")
        n_live = _tile_list_vs_plain(f"[redesign] B4 {what}", tiles, ops_[3])
        run = lambda: S.soft_tiled_fwd(*ops_[:4], cfg=ops_[4])  # noqa: E731
        n = 50 if what.startswith("train") else 20
        b4_ms[what], b2b_ms = device_ms(run, n), back_to_back_ms(run, n)
        lean = ops_[:4] + (dict(ops_[4], stored_finals=False),)
        bound_ms, by, n_ops = P.tiled_soft_bounds(sc_, cam_, cfg_, lean,
                                                 torch.zeros_like(got))[0]
        before = B4_BEFORE[what]
        print(f"[redesign] B4 {what}: {b4_ms[what]:.4f} ms of device time per "
              f"launch, {b2b_ms:.4f} back to back with the wrapper (measured in this "
              f"run; vs twin {err:.5f}, bar {FWD_BAR}; {n_live} of "
              f"{ops_[3].shape[0]} tiles non-empty, the card's list equals its "
              f"plain version); recorded before the redesign {before:.4f} ms of "
              f"device time (recorded / measured = {before / b4_ms[what]:.1f}); "
              f"bound {bound_ms:.5f} ms by {by} "
              f"({n_ops:.4e} operations), {b4_ms[what] / bound_ms:.1f}x over it; {smi}")


def _train_stages(S, state, cam, cfg, loss_fn, smi):
    """The train step's stages (what make_train_step's step runs) back to
    back with a CUDA event between each, so per step they add up to the
    whole: 23 steps, the first 3 a warm-up."""
    import torch

    from opencl_ray_tracer_tpu_torch.parallel import scene_leaves

    stages = ("pack", "soft_bins_for_config", "tables + params",
              "forward (B4)", "loss", "backward (B5 + gather)", "adam")
    per = {name: [] for name in stages + ("step",)}
    leaves = scene_leaves(state.scene)
    for i in range(23):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        ev[0].record()
        packed = state.scene.pack()
        ev[1].record()
        bins = S.soft_bins_for_config(packed, cam, cfg)
        ev[2].record()
        params, taus, tables, counts, kc = S.soft_kernel_inputs(packed, cam, cfg, bins)
        ev[3].record()
        img = S.SoftTiledFunction.apply(params, taus, *tables, counts, kc)
        ev[4].record()
        loss = loss_fn(img)
        ev[5].record()
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        ev[6].record()
        for p, g in zip(leaves.values(), grads):
            p.grad = torch.zeros_like(p) if g is None else g
        state.opt_state.step()
        ev[7].record()
        ev[7].synchronize()
        if i < 3:
            continue
        for j, name in enumerate(stages):
            per[name].append(ev[j].elapsed_time(ev[j + 1]))
        per["step"].append(ev[0].elapsed_time(ev[-1]))
    parts = "; ".join(f"{name} mean {statistics.fmean(v):.4f} median "
                      f"{statistics.median(v):.4f}" for name, v in per.items())
    print(f"[stages] train step 1080p, ms over 20 steps: {parts}; {smi}")


def soft_phase_cli_fit():
    """Phase 9 (b): the CLI's fit on the card at 640x480 (lambert, no
    shadows: the per-primitive shading mode) must lower the loss and the
    largest sphere-origin error."""
    import re

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "opencl_ray_tracer_tpu_torch.cli", "fit",
         "--scene", "1", "--steps", "60"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": root},
    )
    print(proc.stdout.strip())
    _require(proc.returncode == 0, f"cli fit failed:\n{proc.stderr[-4000:]}")
    err = re.search(r"max origin error ([0-9.]+) -> ([0-9.]+)", proc.stdout)
    loss = re.search(r"loss: ([0-9.]+) -> ([0-9.]+)", proc.stdout)
    _require(err and loss, "cli fit printed no result")
    e0, e1 = float(err.group(1)), float(err.group(2))
    l0, l1 = float(loss.group(1)), float(loss.group(2))
    print(f"[fit] cli fit --scene 1 --steps 60: loss {l0} -> {l1}, max origin "
          f"error {e0} -> {e1}; {time.perf_counter() - t0:.1f} s with start-up")
    _require(l1 < l0 and e1 < e0, "cli fit did not lower the loss and the error")


# ---------------------------------------------------------------------------
# The brute path: B3 (hard), B6 (soft forward) and B7 (soft backward)
# ---------------------------------------------------------------------------

def _check_other_formulation(label, got, want):
    """A float frame against the same frame through another formulation of
    the tests (the tiled kernel's tables, the oracle): truncated int frames
    identical on >= 99.9% of pixels, and >= 99.9% of the lit pixels within
    0.5/255 (the least read on an H100 over the 48 comparisons of phase 10:
    99.979% and 99.943%)."""
    import torch

    same = (torch.trunc(got) == torch.trunc(want)).all(-1).float().mean().item()
    close, lit = _lit_agreement(got, want)
    print(f"{label}: int identical {same:.6f}, {close:.6f} of the lit pixels "
          f"within 0.5/255 ({lit:.4f} lit; bars 0.999)")
    _require(same >= 0.999 and close >= 0.999, f"{label}: {same} / {close}")


def brute_phase_hard_vs_twin(T, dev):
    """Phase 10: the brute hard kernel B3 against its plain twin, then
    against the tiled kernel B1 and the oracle on the same frames."""
    import torch

    from opencl_ray_tracer_tpu_torch.kernels import fwd, fwd_tiled
    from opencl_ray_tracer_tpu_torch.ref.tracer import _render_oracle
    from opencl_ray_tracer_tpu_torch.utils import tracing

    before = tracing.counter("launch.B3")
    worst, n_cases = 0.0, 0
    for num, (w, h) in ((1, (640, 480)), (2, (640, 480)), (3, (256, 128))):
        scene = T.create_scene(num, seed=0, device=dev)
        packed = scene.pack()
        for cam_kind in ("ortho", "pinhole"):
            cam = (T.legacy_ortho_camera(device=dev) if cam_kind == "ortho" else
                   T.pinhole_camera((w / 2.0, h / 2.0, 60.0), (w / 2.0, h / 2.0, -85.0),
                                    fov_degrees=80.0, width=w, height=h, device=dev))
            for shading, shadows in (("legacy", False), ("lambert", True),
                                     ("phong", True), ("phong", False)):
                cfg = T.RenderConfig(width=w, height=h, shading=shading,
                                     shadows=shadows, framebuffer_dtype="float")
                label = (f"[brute-parity] scene{num} {w}x{h} {cam_kind} {shading} "
                         f"shadows={shadows}")
                args, kw = fwd.brute_kernel_inputs(packed, cam, cfg)
                got = fwd.brute_kernel(*args, **kw)
                torch.cuda.synchronize()
                want = fwd._brute_kernel_plain(*args, **kw)
                _require(bool(torch.isfinite(got).all()), f"{label}: non-finite")
                worst = max(worst, _check_twin(label, got, want, "float"))
                _check_twin(label, torch.trunc(got).int(), torch.trunc(want).int(),
                            "int")
                _check_other_formulation(
                    f"{label} vs tiled B1", got,
                    fwd_tiled.render_tiled_packed(packed, cam, cfg))
                _check_other_formulation(f"{label} vs oracle", got,
                                         _render_oracle(scene, cam, cfg))
                n_cases += 1
    # 400 cubes (4,800 triangles, 230 KB of geometry): more than the shadow
    # walk can hold in shared memory, so it stages 128 primitives at a time
    # behind block barriers, which no smaller scene does
    big = T.random_scene(20, 400, seed=2, bounds=(150.0, 110.0), device=dev)
    for cam_kind in ("ortho", "pinhole"):
        w, h = 160, 120
        cam = (T.legacy_ortho_camera(device=dev) if cam_kind == "ortho" else
               T.pinhole_camera((w / 2.0, h / 2.0, 60.0), (w / 2.0, h / 2.0, -85.0),
                                fov_degrees=80.0, width=w, height=h, device=dev))
        cfg = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                             framebuffer_dtype="float")
        args, kw = fwd.brute_kernel_inputs(big.pack(), cam, cfg)
        _require(kw["n_tris"] * 48 + kw["n_spheres"] * 16 > 200 * 1024,
                 "the big scene fits in shared memory")
        got = fwd.brute_kernel(*args, **kw)
        unshadowed = fwd.brute_kernel(*args, **{**kw, "shadows": False})
        _require(bool((got != unshadowed).any()), "the big scene casts no shadow")
        worst = max(worst, _check_twin(
            f"[brute-parity] 4800 triangles {w}x{h} {cam_kind} phong shadows=True "
            f"(staged shadow walk)", got, fwd._brute_kernel_plain(*args, **kw),
            "float"))
        n_cases += 1
    launched = tracing.counter("launch.B3") - before
    _require(launched >= n_cases, f"phase 10 launched {launched} kernels")
    print(f"[brute-parity] {n_cases} cases, largest float error vs the twin "
          f"{worst:.4f} (bar < 0.5), {launched} B3 launches")


def _brute_render(scene, cam, cfg, taus=None):
    """The frame through _soft_render_core: B6/B7 on CUDA tensors."""
    from opencl_ray_tracer_tpu_torch.kernels.soft import _soft_render_core

    td, te = taus if taus is not None else (cfg.tau_depth, cfg.tau_edge)
    return _soft_render_core(scene.pack(), cam, td, te, cfg.height, cfg.width,
                             cfg.shading, cfg.shadows, cam.normalize)


def _brute_twin_render(scene, cam, cfg, taus=None):
    """The same frame through the brute kernels' plain twin (autograd-able),
    on the same operands."""
    import torch

    from opencl_ray_tracer_tpu_torch.kernels import soft as B

    packed = scene.pack()
    td, te = taus if taus is not None else (cfg.tau_depth, cfg.tau_edge)
    taus_t = torch.stack([torch.as_tensor(t, dtype=torch.float32,
                                          device=packed.device) for t in (td, te)])
    return B._soft_brute_plain(
        B._camera_params(cam, packed.lights), taus_t, *B._prep_soft_arrays(packed),
        height=cfg.height, width=cfg.width,
        cfg=B._static_cfg(packed, cfg.shading, cfg.shadows, cam.normalize))


def _brute_operands(scene, cam, cfg):
    """The brute soft kernels' operands for a scene: ([params, taus, tri_geo,
    tri_alb, sph_geo, sph_alb], the wrappers' keywords)."""
    import torch

    from opencl_ray_tracer_tpu_torch.kernels import soft as B

    packed = scene.pack()
    inputs = [B._camera_params(cam, packed.lights).contiguous(),
              torch.tensor([cfg.tau_depth, cfg.tau_edge], device=packed.device),
              *(a.contiguous() for a in B._prep_soft_arrays(packed))]
    return inputs, dict(height=cfg.height, width=cfg.width,
                        cfg=B._static_cfg(packed, cfg.shading, cfg.shadows,
                                          cam.normalize))


_OPERANDS = ("params", "taus", "tri_geo", "tri_alb", "sph_geo", "sph_alb")


def _live_count(label, live, g):
    """The list of live patches that B7 built on the card for the cotangent
    g, held against its plain version: the same patches, in any order.
    Returns their number, read from the kernel's counter."""
    import torch

    from opencl_ray_tracer_tpu_torch.kernels import soft as B

    want = B._live_patches(g)
    n = int(live[0].item())
    _require(n == want.numel(), f"{label}: the card lists {n} live patches, the "
                                f"plain version {want.numel()}")
    _require(torch.equal(live[2:2 + n].sort().values.long(), want),
             f"{label}: the card's live patches differ from the plain version's")
    return n


def _b7_vs_twin(label, inputs, g, skw, atol=1e-3):
    """B7 on a cotangent g against the twin's autograd on the same operands:
    the largest error over the six operands, each normalised by its largest."""
    import torch

    from opencl_ray_tracer_tpu_torch.kernels import soft as B

    got, live = B._soft_brute_bwd_cuda(inputs, g, skw["height"], skw["width"],
                                       skw["cfg"])
    _live_count(label, live, g)
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    want = torch.autograd.grad(B._soft_brute_plain(*leaves, **skw), leaves, g,
                               allow_unused=True)
    want = [torch.zeros_like(t) if w is None else w for t, w in zip(inputs, want)]
    return _compare_grads(label, dict(zip(_OPERANDS, got)),
                          dict(zip(_OPERANDS, want)), atol)


_CAMERA_LEAVES = ("o0", "dox", "doy", "d0", "ddx", "ddy")


def _all_leaf_grads(render, scene, cam, cfg, loss_fn):
    """Gradients of every leaf: the scene's and the lights', the camera's
    six tensors and both temperatures."""
    import dataclasses

    import torch

    from opencl_ray_tracer_tpu_torch.parallel.train import (
        scene_leaves,
        trainable_scene,
    )

    s = trainable_scene(scene)
    leaves = dict(scene_leaves(s))
    cam_t = {k: getattr(cam, k).detach().clone().requires_grad_(True)
             for k in _CAMERA_LEAVES}
    leaves.update({f"camera.{k}": v for k, v in cam_t.items()})
    taus = [torch.tensor(v, dtype=torch.float32, device=cam.device,
                         requires_grad=True) for v in (cfg.tau_depth, cfg.tau_edge)]
    leaves.update({"tau_depth": taus[0], "tau_edge": taus[1]})
    loss = loss_fn(render(s, dataclasses.replace(cam, **cam_t), cfg, taus))
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), grads)}


def brute_phase_soft_vs_twin(T, dev):
    """Phase 11: B6/B7 against the twin at 256x128 through
    _soft_render_core, then the brute path against the tiled path."""
    import torch

    from opencl_ray_tracer_tpu_torch.kernels import soft as B
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
    from opencl_ray_tracer_tpu_torch.utils import tracing

    before = (tracing.counter("launch.B6"), tracing.counter("launch.B7"))
    worst_f, worst_g, n = 0.0, 0.0, 0
    for scene_name in ("test", "scene1"):
        scene = (T.random_scene(5, 3, seed=4, bounds=(250.0, 120.0), device=dev)
                 if scene_name == "test" else T.create_scene1(device=dev))
        for cam_kind in ("ortho", "pinhole"):
            cam = (T.legacy_ortho_camera(device=dev) if cam_kind == "ortho"
                   else T.pinhole_camera(**SOFT_PINHOLE, device=dev))
            atol = 1e-3 if cam_kind == "ortho" else 2e-3
            for shading, shadows in SOFT_MODES:
                cfg = _soft_cfg(T, SOFT_W, SOFT_H, shading, shadows)
                label = (f"[brute-soft-parity] {scene_name} {cam_kind} {shading} "
                         f"shadows={shadows}")
                with torch.no_grad():
                    got = _brute_render(scene, cam, cfg)
                    want = _brute_twin_render(scene, cam, cfg)
                torch.cuda.synchronize()
                _require(bool(torch.isfinite(got).all()), f"{label}: non-finite")
                ferr = (got - want).abs().max().item()
                _require(ferr < FWD_BAR, f"{label}: fwd max err {ferr} >= {FWD_BAR}")
                gk = _all_leaf_grads(_brute_render, scene, cam, cfg, _mean_sq)
                gt = _all_leaf_grads(_brute_twin_render, scene, cam, cfg, _mean_sq)
                gerr = _compare_grads(label, gk, gt, atol)
                msg = (f"{label}: fwd max err {ferr:.5f} (bar {FWD_BAR}), all-leaf "
                       f"grads normalised max err {gerr:.2e} (bar {atol})")
                if cam_kind == "ortho":
                    # the tiled path culls what lies > 16 tau_edge from a
                    # tile: invisible on these scenes
                    with torch.no_grad():
                        terr = (got - S.render_soft_tiled(scene, cam, cfg)
                                ).abs().max().item()
                    _require(terr < FWD_BAR, f"{label}: brute vs tiled {terr}")
                    gs = _leaf_grads(_brute_render, scene, cam, cfg, _mean_sq)
                    gtile = _leaf_grads(S.render_soft_tiled, scene, cam, cfg, _mean_sq)
                    tgerr = _compare_grads(f"{label} vs tiled", gs, gtile, 1e-3)
                    msg += (f"; vs tiled B4/B5: image {terr:.5f}, scene-leaf grads "
                            f"{tgerr:.2e} (bar 1e-3)")
                print(msg)
                worst_f, worst_g, n = max(worst_f, ferr), max(worst_g, gerr), n + 1
    # scene 3: 1,300 primitives
    scene = T.create_scene(3, seed=0, device=dev)
    cam = T.legacy_ortho_camera(device=dev)
    cfg = _soft_cfg(T, SOFT_W, SOFT_H, "phong", True)
    label = "[brute-soft-parity] scene3 (1300 primitives) ortho phong shadows=True"
    with torch.no_grad():
        ferr = (_brute_render(scene, cam, cfg)
                - _brute_twin_render(scene, cam, cfg)).abs().max().item()
    _require(ferr < FWD_BAR, f"{label}: fwd max err {ferr} >= {FWD_BAR}")
    gerr = _compare_grads(label,
                          _all_leaf_grads(_brute_render, scene, cam, cfg, _mean_sq),
                          _all_leaf_grads(_brute_twin_render, scene, cam, cfg, _mean_sq),
                          1e-3)
    print(f"{label}: fwd max err {ferr:.5f} (bar {FWD_BAR}), all-leaf grads "
          f"normalised max err {gerr:.2e} (bar 0.001)")
    worst_f, worst_g, n = max(worst_f, ferr), max(worst_g, gerr), n + 1

    # Two and three lights: one light has kernels of its own, built with the
    # light count known; any other count runs the builds that read it at run
    # time, which the one-light scenes above never launch.
    for n_lights, shading, shadows in ((2, "phong", True), (3, "lambert", True)):
        scene = _multi_light_scene(T, dev, n_lights)
        cfg_l = _soft_cfg(T, SOFT_W, SOFT_H, shading, shadows)
        label = (f"[brute-soft-parity] test, {n_lights} lights, ortho {shading} "
                 f"shadows={shadows}")
        with torch.no_grad():
            ferr = (_brute_render(scene, cam, cfg_l)
                    - _brute_twin_render(scene, cam, cfg_l)).abs().max().item()
        _require(ferr < FWD_BAR, f"{label}: fwd max err {ferr} >= {FWD_BAR}")
        gk = _all_leaf_grads(_brute_render, scene, cam, cfg_l, _mean_sq)
        gt = _all_leaf_grads(_brute_twin_render, scene, cam, cfg_l, _mean_sq)
        gerr = _compare_grads(label, gk, gt, 1e-3)
        _require(bool((gk["lights.position"][n_lights - 1] != 0).any()),
                 f"{label}: the last light's position has no gradient")
        print(f"{label}: fwd max err {ferr:.5f} (bar {FWD_BAR}), all-leaf grads "
              f"normalised max err {gerr:.2e} (bar 0.001)")
        worst_f, worst_g, n = max(worst_f, ferr), max(worst_g, gerr), n + 1

    # B7 and its cotangent: the kernel works only where g is non-zero
    scene = T.random_scene(5, 3, seed=4, bounds=(250.0, 120.0), device=dev)
    inputs, skw = _brute_operands(scene, cam, cfg)
    zero_g = torch.zeros((SOFT_H, SOFT_W, 4), device=dev)
    zeros, live = B._soft_brute_bwd_cuda(inputs, zero_g, SOFT_H, SOFT_W, skw["cfg"])
    _require(all(bool((t == 0).all()) for t in zeros) and live[0].item() == 0,
             "[brute-soft-parity] B7 with an all-zero cotangent is not exactly zero")
    g = zero_g.clone()
    g[3, 5, 1], g[77, 200, 0], g[SOFT_H - 1, SOFT_W - 1, 2] = 1.0, -2.0, 0.5
    g[40:44, 96:104, :3] = 0.5  # one whole patch
    gerr = _b7_vs_twin("[brute-soft-parity] B7, scattered pixels + one patch",
                       inputs, g, skw)
    print(f"[brute-soft-parity] B7: all-zero cotangent -> exact zeros; 3 scattered "
          f"pixels + one 8x4 patch vs the twin's autograd {gerr:.2e} (bar 0.001)")
    worst_g = max(worst_g, gerr)
    # more primitives than the kernel's accumulators once held (2,400)
    big = T.random_scene(200, 200, seed=1, bounds=(60.0, 30.0), device=dev)
    cfg_big = _soft_cfg(T, 64, 32, "phong", True)
    inputs, skw = _brute_operands(big, cam, cfg_big)
    n_prims = skw["cfg"]["n_tris"] + skw["cfg"]["n_spheres"]
    _require(n_prims > 2400, f"the big scene has {n_prims} primitives")
    with torch.no_grad():
        img = B.soft_brute_fwd(*inputs, **skw)
        ferr = (img - B._soft_brute_plain(*inputs, **skw)).abs().max().item()
    _require(ferr < FWD_BAR, f"[brute-soft-parity] {n_prims} primitives: fwd {ferr}")
    g = torch.zeros_like(img)
    g[..., :3] = 2.0 * img[..., :3] / (64 * 32 * 3)
    gerr = _b7_vs_twin(f"[brute-soft-parity] {n_prims} primitives", inputs, g, skw)
    print(f"[brute-soft-parity] {n_prims} primitives at 64x32: fwd max err "
          f"{ferr:.5f} (bar {FWD_BAR}), B7 vs the twin's autograd {gerr:.2e} "
          f"(bar 0.001)")
    worst_f, worst_g, n = max(worst_f, ferr), max(worst_g, gerr), n + 2
    launched = (tracing.counter("launch.B6") - before[0],
                tracing.counter("launch.B7") - before[1])
    _require(launched[0] > 0 and launched[1] > 0, f"phase 11 launches {launched}")
    print(f"[brute-soft-parity] {n} cases: fwd max err {worst_f:.5f}, grads "
          f"{worst_g:.2e}; {launched[0]} B6 and {launched[1]} B7 launches")


def brute_phase_full_size(T, dev, smi):
    """Phase 12: the brute path at 1080p on the headline scene through its
    entry points, its kernels' times and bounds, and the port's bench."""
    import torch

    from opencl_ray_tracer_tpu_torch.bench_util import back_to_back_ms, device_ms
    from opencl_ray_tracer_tpu_torch.kernels import fwd, fwd_tiled
    from opencl_ray_tracer_tpu_torch.kernels import render_pallas_packed
    from opencl_ray_tracer_tpu_torch.kernels import soft as B
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
    from opencl_ray_tracer_tpu_torch.utils import profiling as P
    from opencl_ray_tracer_tpu_torch.utils import tracing

    w, h = 1920, 1080
    n_pix = w * h
    scene = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
    packed = scene.pack()
    cam = T.legacy_ortho_camera(device=dev)
    cfg_int = T.RenderConfig(width=w, height=h, shading="legacy",
                             framebuffer_dtype="int")
    cfg_phong = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                               framebuffer_dtype="float")
    cfg_soft = _soft_cfg(T, w, h, "phong", True)

    # ---- the main path, counted: both hard frames, one soft fwd + bwd ------
    tracing.reset()
    frame_int = render_pallas_packed(packed, cam, cfg_int)
    frame_phong = render_pallas_packed(packed, cam, cfg_phong)
    g_brute = _leaf_grads(_brute_render, scene, cam, cfg_soft, _mean_sq)
    torch.cuda.synchronize()
    launches = tuple(tracing.counter(f"launch.{k}") for k in ("B3", "B6", "B7"))
    print(f"[brute] launches in the main-path run: B3 {launches[0]}, B6 "
          f"{launches[1]}, B7 {launches[2]}")
    _require(launches[0] >= 2 and launches[1] >= 1 and launches[2] >= 1,
             f"the brute path did not go through its kernels: {launches}")

    _require(tuple(frame_int.shape) == (h, w, 4) and frame_int.dtype == torch.int32
             and tuple(frame_phong.shape) == (h, w, 4)
             and frame_phong.dtype == torch.float32, "bad brute frames")
    _require(bool(torch.isfinite(frame_phong).all()), "non-finite brute frame")
    tiled_int = fwd_tiled.render_tiled_packed(packed, cam, cfg_int)
    same = (frame_int == tiled_int).all(-1).float().mean().item()
    lit = (frame_int[..., :3] > 0).any(-1).float().mean().item()
    print(f"[brute] 1080p legacy int vs tiled B1: {same:.6f} identical (bar "
          f"0.999), {lit:.4f} of pixels lit")
    _require(same >= 0.999 and lit > 0.001, f"brute legacy frame vs tiled: {same}")
    _check_other_formulation("[brute] 1080p phong+shadows float vs tiled B1",
                             frame_phong,
                             fwd_tiled.render_tiled_packed(packed, cam, cfg_phong))

    # kernel vs twin on the main path's own inputs (max_abs_err of the rows)
    args_i, kw_i = fwd.brute_kernel_inputs(packed, cam, cfg_int)
    args_p, kw_p = fwd.brute_kernel_inputs(packed, cam, cfg_phong)
    b3_err = max(
        _check_twin("[brute] 1080p legacy: B3 vs twin", fwd.brute_kernel(*args_i, **kw_i),
                    fwd._brute_kernel_plain(*args_i, **kw_i), "float"),
        _check_twin("[brute] 1080p phong+shadows: B3 vs twin",
                    fwd.brute_kernel(*args_p, **kw_p),
                    fwd._brute_kernel_plain(*args_p, **kw_p), "float"))

    # Two paths, not a kernel and its twin: the tiled one culls what lies
    # beyond 16 tau_edge of a tile and evaluates pixel-affine coefficients
    # with FMAs, the brute one tests general rays in plain float32 at
    # coordinates up to 1920, and both sum 2 M pixels in their own order.
    # At 256x128 they agree within 1e-3 (phase 11); here the bar is 5e-3
    # (the frames themselves differ near tile borders, see below).
    g_tiled = _leaf_grads(S.render_soft_tiled, scene, cam, cfg_soft, _mean_sq)
    gerr_tiled = _compare_grads("[brute] 1080p step-1 grads vs tiled", g_brute,
                                g_tiled, 5e-3, lost_floor=5e-3)
    inputs, skw = _brute_operands(scene, cam, cfg_soft)
    from opencl_ray_tracer_tpu_torch.diff import render_soft

    with torch.no_grad():
        img = B.soft_brute_fwd(*inputs, **skw)
        twin_img = B._soft_brute_plain(*inputs, **skw)
        oracle_err = (img - render_soft(scene, cam, cfg_soft)).abs().max().item()
        tiled_diff = (img - S.render_soft_tiled(scene, cam, cfg_soft)).abs().amax(-1)
    b6_err = (img - twin_img).abs().max().item()
    # The brute frame is held to its twin and to the diff.render_soft oracle
    # on every pixel. The tiled frame is another function: it depends on its
    # tile grid (up to ~2/255 on a few hundred pixels of this frame, as the
    # JAX package's tiled frame departs from its own oracle; raising the
    # 16-tau_edge cull changes no pixel of it: scripts/torch_soft_tiling.py),
    # so it is held to 99.9% of the pixels.
    tiled_close = (tiled_diff < FWD_BAR).float().mean().item()
    _require(b6_err < FWD_BAR and oracle_err < FWD_BAR and tiled_close >= 0.999,
             f"[brute] 1080p soft frame: vs twin {b6_err}, vs oracle {oracle_err}, "
             f"{tiled_close} of pixels within {FWD_BAR} of the tiled frame")
    g = torch.zeros_like(img)
    g[..., :3] = 2.0 * img[..., :3] / (n_pix * 3)   # d mean(img^2) / d img
    b7_err = _b7_vs_twin("[brute] 1080p B7 vs twin", inputs, g, skw)
    print(f"[brute] 1080p phong+soft shadows: B6 vs twin {b6_err:.5f}, vs "
          f"diff.render_soft {oracle_err:.5f} (bar {FWD_BAR}); vs tiled B4 "
          f"{tiled_close:.6f} of pixels within {FWD_BAR} (bar 0.999), max "
          f"{tiled_diff.max().item():.4f}; B7 vs the twin's autograd "
          f"{b7_err:.2e} (bar 1e-3), step-1 scene-leaf grads vs the tiled path "
          f"{gerr_tiled:.2e} (bar 5e-3)")

    # ---- times: CUDA events, median [min, max] ------------------------------
    zero_g = torch.zeros_like(g)
    dense_g = torch.full_like(g, 1e-6)
    # scene 3 (1,300 primitives): B7 at phase 11's size, B6 on a frame that
    # it mostly covers
    scene3 = T.create_scene(3, seed=0, device=dev)
    cfg3 = _soft_cfg(T, SOFT_W, SOFT_H, "phong", True)
    cfg3_big = _soft_cfg(T, 640, 480, "phong", True)
    in3, skw3 = _brute_operands(scene3, cam, cfg3)
    in3_big, skw3_big = _brute_operands(scene3, cam, cfg3_big)
    img3 = B.soft_brute_fwd(*in3, **skw3)
    g3 = torch.zeros_like(img3)
    g3[..., :3] = 2.0 * img3[..., :3] / (SOFT_W * SOFT_H * 3)
    dense_err = _b7_vs_twin("[brute] 1080p B7, dense cotangent, vs twin", inputs,
                            dense_g, skw)
    print(f"[brute] 1080p B7 with a cotangent of 1e-6 on every pixel vs the "
          f"twin's autograd {dense_err:.2e} (bar 1e-3)")

    def twin_b7():
        lv = [t.detach().requires_grad_(True) for t in inputs]
        torch.autograd.grad(B._soft_brute_plain(*lv, **skw), lv, g, allow_unused=True)

    def twin_b6():
        with torch.no_grad():
            B._soft_brute_plain(*inputs, **skw)

    def soft_fwd_bwd(render):
        def run():
            from opencl_ray_tracer_tpu_torch.parallel.train import trainable_scene

            _mean_sq(render(trainable_scene(scene), cam, cfg_soft)).backward()
        return run

    bins = fwd_tiled.bin_for_config(packed, cam, cfg_int.replace(framebuffer_dtype="packed"))
    fns = {
        "B3 legacy": (lambda: fwd.brute_kernel(*args_i, **kw_i), 20),
        "B3 phong+shadows": (lambda: fwd.brute_kernel(*args_p, **kw_p), 20),
        "B3 legacy twin": (lambda: fwd._brute_kernel_plain(*args_i, **kw_i), 5),
        "B3 phong+shadows twin": (lambda: fwd._brute_kernel_plain(*args_p, **kw_p), 5),
        "B6": (lambda: B.soft_brute_fwd(*inputs, **skw), 20),
        "B7": (lambda: B.soft_brute_bwd(*inputs, g, **skw), 20),
        "B7, dense cotangent": (lambda: B.soft_brute_bwd(*inputs, dense_g, **skw), 20),
        "B6, scene 3 640x480": (lambda: B.soft_brute_fwd(*in3_big, **skw3_big), 20),
        "B7, scene 3 256x128": (lambda: B.soft_brute_bwd(*in3, g3, **skw3), 20),
        "B6 twin": (twin_b6, 3),
        "B7 twin (forward + autograd backward)": (twin_b7, 2),
        "whole render_pallas_packed legacy int": (
            lambda: render_pallas_packed(packed, cam, cfg_int), 50),
        "whole render_tiled_packed legacy packed, per-frame bins": (
            lambda: fwd_tiled.render_tiled_packed(
                packed, cam, cfg_int.replace(framebuffer_dtype="packed")), 50),
        "whole render_tiled_packed legacy packed, static bins": (
            lambda: fwd_tiled.render_tiled_packed(
                packed, cam, cfg_int.replace(framebuffer_dtype="packed"), bins=bins), 50),
        "whole _soft_render_core fwd+bwd": (soft_fwd_bwd(_brute_render), 20),
        "whole render_soft_tiled fwd+bwd": (soft_fwd_bwd(S.render_soft_tiled), 20),
    }
    times = {}
    for what, (fn, n) in fns.items():
        times[what] = _time_ms(fn, n, 1)
        med, lo, hi = times[what]
        print(f"[time] brute 1080p 10sph+1cube: {what} median {med:.4f} ms "
              f"[{lo:.4f}, {hi:.4f}] over {n} runs; {smi}")
    b2b = {}
    for what, fn in (("B3 legacy", fns["B3 legacy"][0]),
                     ("B3 phong+shadows", fns["B3 phong+shadows"][0]),
                     ("B6", fns["B6"][0]), ("B7", fns["B7"][0]),
                     ("B7, dense cotangent", fns["B7, dense cotangent"][0]),
                     ("B7, all-zero cotangent",
                      lambda: B.soft_brute_bwd(*inputs, zero_g, **skw)),
                     ("B6, scene 3 640x480", fns["B6, scene 3 640x480"][0]),
                     ("B7, scene 3 256x128", fns["B7, scene 3 256x128"][0])):
        b2b[what] = back_to_back_ms(fn, 50)
        print(f"[time] brute 1080p 10sph+1cube: {what} back to back "
              f"{b2b[what]:.4f} ms per launch over 50; {smi}")

    # The JAX package times two frame counts and reports the slope, to cancel
    # a constant cost per dispatch. Here: the same slope from runs of 13 and
    # 100 calls, beside the two event timings above.
    for what in ("whole render_pallas_packed legacy int",
                 "whole render_tiled_packed legacy packed, static bins"):
        fn = fns[what][0]
        t13, t100 = 13 * back_to_back_ms(fn, 13), 100 * back_to_back_ms(fn, 100)
        med, lo, hi = times[what]
        print(f"[time] brute 1080p 10sph+1cube: {what}: two-count slope "
              f"{(t100 - t13) / 87:.4f} ms, events per call median {med:.4f} ms "
              f"[{lo:.4f}, {hi:.4f}], back to back {t100 / 100:.4f} ms; {smi}")

    # ---- bounds, from this run's data ----------------------------------------
    b3_bound = P.b3_bound(args_p, kw_p)
    ops_b3, n_lit, n_occ = b3_bound[2:]
    b6_bound, b7_bound, n_cov, n_cot = P.brute_soft_bounds(scene, cam, cfg_soft,
                                                          inputs, g)
    print(f"[bound] brute 1080p: B3 phong+shadows {ops_b3:.4e} operations "
          f"({n_lit} lit, {n_occ} occluded), bound {b3_bound[0]:.5f} ms by "
          f"{b3_bound[1]}; B6 {b6_bound[2]:.4e} operations ({n_cov} covered pixels "
          f"of {n_pix}), bound {b6_bound[0]:.5f} ms by {b6_bound[1]}; B7 "
          f"{b7_bound[2]:.4e} operations ({n_cot} pixels with a non-zero "
          f"cotangent), bound {b7_bound[0]:.5f} ms by {b7_bound[1]}")
    # The redesigned kernels beside their bounds and beside the same inputs
    # through the kernels as they were before (one thread a pixel in 32x1
    # strips, every pixel's backward whatever its cotangent, accumulators in
    # shared memory). The earlier times are RECORDED, not measured in this
    # run: the `ms` column (back to back per launch, as `b2b` here; not its
    # `device_ms`) of scripts/torch_kernel_times.py --kernel B6 (then its own
    # script, torch_soft_brute_times.py) on the earlier tree,
    # on an NVIDIA H100 80GB HBM3 at 700.00 W, old and new trees in turns on
    # one card. They stay out of the `kernels` line.
    before = {"B6": 0.9326, "B7": 8.8283, "B7, dense cotangent": 8.8046,
              "B7, all-zero cotangent": 8.7326, "B6, scene 3 640x480": 8.9490,
              "B7, scene 3 256x128": 10.5906}
    bounds = {
        "B6": b6_bound, "B7": b7_bound,
        "B7, dense cotangent": P.brute_soft_bounds(scene, cam, cfg_soft, inputs,
                                                  dense_g)[1],
        "B7, all-zero cotangent": P.brute_soft_bounds(scene, cam, cfg_soft, inputs,
                                                     zero_g)[1],
        "B6, scene 3 640x480": P.brute_soft_bounds(
            scene3, cam, cfg3_big, in3_big, torch.zeros((480, 640, 4), device=dev))[0],
        "B7, scene 3 256x128": P.brute_soft_bounds(scene3, cam, cfg3, in3, g3)[1],
    }
    walked = [_live_count(f"[redesign] {what}",
                          B._soft_brute_bwd_cuda(ins, cot, kw_["height"],
                                                 kw_["width"], kw_["cfg"])[1], cot)
              for what, ins, cot, kw_ in (("headline", inputs, g, skw),
                                          ("scene 3", in3, g3, skw3))]
    print(f"[redesign] B7's list kernel found {walked[0]} of "
          f"{-(-w // B.PATCH_W) * -(-h // B.PATCH_H)} 8x4 patches live for the "
          f"loss's cotangent on the headline frame, {walked[1]} of "
          f"{-(-SOFT_W // B.PATCH_W) * -(-SOFT_H // B.PATCH_H)} on scene 3 (read "
          f"from the kernel's counter; the lists equal their plain version)")
    for what, (bound_ms, by, ops) in bounds.items():
        print(f"[redesign] {what}: {b2b[what]:.4f} ms back to back per launch "
              f"(measured in this run); recorded before the redesign "
              f"{before[what]:.4f} ms (recorded / measured = "
              f"{before[what] / b2b[what]:.1f}); bound {bound_ms:.5f} ms by {by} "
              f"({ops:.4e} operations), {b2b[what] / bound_ms:.1f}x over it; {smi}")

    # B3 the same way: the headline frame (legacy, the bench's brute row, and
    # phong + shadows), the same through a pinhole camera, and scene 3 (1,300
    # primitives) at 640x480, where the shadow walk is most of the work; each
    # held against the twin on every pixel first. Device time behind a spin;
    # recorded: the `device_ms` column of scripts/torch_kernel_times.py on
    # the earlier tree (one pixel a thread, operands staged row-major,
    # barriers in the shadow walk).
    pin = T.pinhole_camera((960.0, 540.0, 1100.0), (960.0, 540.0, -60.0),
                           fov_degrees=50.0, width=w, height=h, device=dev)
    packed3 = scene3.pack()
    cfg3_hard = T.RenderConfig(width=640, height=480, shading="phong",
                               shadows=True, framebuffer_dtype="float")
    for what, inp, before_ms, n in (
        ("B3 legacy", (args_i, kw_i), 0.0941, 50),
        ("B3 phong+shadows", (args_p, kw_p), 0.1269, 50),
        ("B3 legacy, pinhole camera",
         fwd.brute_kernel_inputs(packed, pin, cfg_int), 0.1319, 50),
        ("B3 phong+shadows, pinhole camera",
         fwd.brute_kernel_inputs(packed, pin, cfg_phong), 0.1557, 50),
        ("B3 phong+shadows, scene 3 640x480",
         fwd.brute_kernel_inputs(packed3, cam, cfg3_hard), 1.5638, 10),
    ):
        args_, kw_ = inp
        got = fwd.brute_kernel(*args_, **kw_)
        want = fwd._brute_kernel_plain(*args_, **kw_)
        _check_twin(f"[redesign] {what}: B3 vs twin", got, want, "float")
        same = (got == want).all(-1).float().mean().item()
        run = lambda: fwd.brute_kernel(*args_, **kw_)  # noqa: E731
        ms, b2b_ms = device_ms(run, n), back_to_back_ms(run, n)
        bound_ms, by, n_ops, lit_, occ_ = P.b3_bound(args_, kw_)
        print(f"[redesign] {what}: {ms:.4f} ms of device time per launch, "
              f"{b2b_ms:.4f} back to back with the wrapper (measured in this run; "
              f"{same:.6f} of pixels bit-identical to the twin); recorded before "
              f"the redesign {before_ms:.4f} ms of device time (recorded / "
              f"measured = {before_ms / ms:.1f}); bound {bound_ms:.5f} ms by {by} "
              f"({n_ops:.4e} operations, {lit_} lit, {occ_} occluded), "
              f"{ms / bound_ms:.1f}x over it; {smi}")

    # ---- the port's bench, as a user runs it ------------------------------------
    from opencl_ray_tracer_tpu_torch import bench

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "opencl_ray_tracer_tpu_torch.bench", "--skip-scaling"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": root},
    )
    # each re-binning of an overflowing list logs a warning: count them
    err_lines = proc.stderr.strip().splitlines()
    rebins = [ln for ln in err_lines if "overflow: re-binning" in ln]
    print("\n".join(ln for ln in err_lines if "overflow: re-binning" not in ln))
    print(f"[bench] {len(rebins)} re-binning warnings on stderr"
          + (f", the last: {rebins[-1]}" if rebins else ""))
    # a soft row whose lists overflow its caps would render the brute soft
    # frame (as the JAX package does) while reporting the re-binned caps
    soft_rebins = [ln for ln in rebins if "soft tile candidate overflow" in ln]
    _require(not soft_rebins, f"a soft bench row overflows its K caps: {soft_rebins}")
    _require(proc.returncode == 0, f"the bench failed:\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    _require(len(lines) == 1, f"the bench printed {len(lines)} stdout lines")
    result = json.loads(lines[0])
    print(f"[bench] {lines[0]}")
    for key in ("metric", "value", "unit", "rows", "parity_pixel_grad_max_err",
                "train_step_ms", "device", "dynamic_frame_ms",
                "stress_fwd_bwd_rays_per_s", "sol_fraction", "sol_bound",
                "sol_fraction_bwd", "sol_bwd_bound", "shard_map_overhead"):
        _require(key in result, f"the bench's JSON line lacks {key!r}")
    for key in ("headline_graph_us", "dynamic_graph_us", "fwd_bwd_graph_us",
                "train_graph_us"):  # the JAX bench's slopes (phase 16)
        _require(result.get(key, 0) > 0, f"the bench's {key!r}: {result.get(key)}")
    rows = result["rows"]
    plan = bench.row_plan(bench.parse_args([]))
    _require(list(rows) == plan and len(rows) == 13,
             f"the bench's rows {list(rows)} are not its plan {plan}")
    _require(all(r["ms"] > 0 and r["ms_min"] <= r["ms"] <= r["ms_max"]
                 and r["device_ms"] > 0 and r["device_busy_ms"] > 0
                 for r in rows.values()), f"bad bench rows: {rows}")
    tiled = [lb for lb in plan if lb not in (bench.BRUTE_LEGACY, bench.TRAIN)]
    _require(all("k" in rows[lb] and "shadow_k" in rows[lb] for lb in tiled),
             "a tiled bench row lacks its final K caps")
    _require(0 < result["sol_fraction"] <= 1 and 0 < result["sol_fraction_bwd"] <= 1,
             "the bench's speed-of-light fractions are out of (0, 1]")
    _require(result["parity_legacy_frac_identical"] > 0.999
             and result["parity_phong_frac_close"] >= 0.995
             and result["parity_pixel_grad_max_err"] <= 1e-4,
             "the bench's parity scalars are off their bars")
    _require(not any(k.startswith("sharding_eff") for k in result),
             "--skip-scaling left the scaling keys in")
    print(f"[bench] {len(rows)} rows, headline {result['value']:.4e} "
          f"rays/s; sharded forward on a one-rank mesh "
          f"{result['sharded_fwd_ms']:.4f} ms vs {result['unsharded_fwd_ms']:.4f} "
          f"(shard_map_overhead {result['shard_map_overhead']:+.4f}); "
          f"{time.perf_counter() - t0:.1f} s with start-up")

    shape = "1920x1080 10sph+1cube, legacy ortho camera"
    return [
        {"name": "fwd_brute", "route": "cuda",
         "source": "opencl_ray_tracer_tpu_torch/kernels/csrc/fwd_brute.cu",
         "replaces": "opencl_ray_tracer_tpu/kernels/fwd.py:67",
         "launches": launches[0], "max_abs_err": b3_err,
         "tolerance": "every pixel within 0.5/255 of the twin",
         "shape": shape + ", phong + hard shadows, float frame",
         "ms": times["B3 phong+shadows"][0],
         "plain_ms": times["B3 phong+shadows twin"][0],
         "bound_ms": b3_bound[0], "bound_by": b3_bound[1], "library_ms": None},
        {"name": "soft_brute_fwd", "route": "cuda",
         "source": "opencl_ray_tracer_tpu_torch/kernels/csrc/soft_brute.cu",
         "replaces": "opencl_ray_tracer_tpu/kernels/soft.py:494",
         "launches": launches[1],
         "launch_is": "one wrapper call: the row kernel, then the pixel kernel",
         "max_abs_err": b6_err,
         "tolerance": f"every pixel within {FWD_BAR}/255 of the twin",
         "shape": shape + ", phong + soft shadows",
         "ms": times["B6"][0], "plain_ms": times["B6 twin"][0],
         "bound_ms": b6_bound[0], "bound_by": b6_bound[1], "library_ms": None},
        {"name": "soft_brute_bwd", "route": "cuda",
         "source": "opencl_ray_tracer_tpu_torch/kernels/csrc/soft_brute.cu",
         "replaces": "opencl_ray_tracer_tpu/kernels/soft.py:543",
         "launches": launches[2],
         "launch_is": "one wrapper call: the row kernel, the kernel that lists "
                      "the live patches, the pixel kernel, then the row-gradient "
                      "kernel",
         "max_abs_err": b7_err,
         "tolerance": "every operand's gradient within 1e-3 of the twin's "
                      "autograd, normalised by its largest (max_abs_err is that "
                      "normalised error)",
         "shape": shape + ", phong + soft shadows, the cotangent of mean(img^2)",
         "ms": times["B7"][0],
         "plain_ms": times["B7 twin (forward + autograd backward)"][0],
         "bound_ms": b7_bound[0], "bound_by": b7_bound[1], "library_ms": None},
    ]


# ---------------------------------------------------------------------------
# Configurations new to the card: the stress scenes, 4K, the dynamic frame
# and the whole-frame xla backend
# ---------------------------------------------------------------------------

def _b1_case(label, scene, cam, cfg, smi):
    """B1 (B2 for a float frame) on one frame at full size: the card's frame
    against the twin on every pixel, its list of non-empty tiles against the
    plain version, the final K caps, the device time per launch and the
    bound."""
    from opencl_ray_tracer_tpu_torch.bench_util import device_ms
    from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
    from opencl_ray_tracer_tpu_torch.utils import profiling as P

    packed = scene.pack()
    bins = fwd_tiled.bin_for_config(packed, cam, cfg)
    fmt = cfg.framebuffer_dtype
    args, kw = fwd_tiled.kernel_inputs(
        packed, cam, bins, height=cfg.height, width=cfg.width,
        shading=cfg.shading, shadows=cfg.shadows, out_format=fmt)
    got, tiles = fwd_tiled._tiled_kernel_cuda(*args, **kw)
    _check_twin(f"[new] {label}: B1 vs twin", got,
                fwd_tiled._tiled_kernel_plain(*args, **kw), fmt)
    n_live = _tile_list_vs_plain(f"[new] {label}", tiles, args[1])
    ms = device_ms(lambda: fwd_tiled.tiled_kernel(*args, **kw), 20)
    bound_ms, by, n_ops, lit, occ = P.b1_bound(args, kw)
    rows = sum(args[i].shape[1] for i in (2, 4, 6, 7))
    print(f"[new] {label}: final K caps k={max(bins.k_tri, bins.k_sph)} "
          f"shadow_k={max(bins.k_sh_tri, bins.k_sh_sph)} (asked {cfg.cull_k}, "
          f"{cfg.shadow_cull_k}); {rows} table rows a tile ({rows * 64} B; "
          f"staged up to 48 KB, else read through L1); {n_live} of "
          f"{args[1].shape[0]} tiles non-empty, the card's list equals "
          f"fwd_tiled._live_tiles; {ms:.4f} ms of device time per launch, bound "
          f"{bound_ms:.5f} ms by {by} ({n_ops:.4e} operations, {lit} lit, {occ} "
          f"occluded), {ms / bound_ms:.1f}x over it; {smi}")


def new_sizes_phase(T, dev, smi):
    """Phase 13: the configurations that the bench now runs and that no
    earlier phase ran at full size. First their main path, through the
    entry points a user calls, with the launch counts set to 0 just before
    and read just after: the dynamic frame (the headline frame through the
    bench's pinhole camera, re-binned inside the call), the 1080p stress
    and 4K frames through render(backend="pallas"), the headline frame as
    float RGBA (B2), and the stress soft step forward + backward. Then each
    against its plain twin or the oracle at the bars of PERF.md section 2:
    B1 on the stress and 4K frames (every pixel; the K caps, the live tiles
    and the card's tile list), B4 on the stress soft frame (0.05/255, full
    size), B5's leaf gradients on the stress soft step (1e-3 normalised, at
    the largest size whose twin fits the card), the dynamic frame against
    render_tiled_packed with precomputed bins (identical words), and
    render(backend="xla") on the 1080p headline frame against the oracle
    and B1. Returns the launches of its main path per kernel."""
    import torch

    from opencl_ray_tracer_tpu_torch.bench_util import device_ms
    from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
    from opencl_ray_tracer_tpu_torch.models.renderer import render
    from opencl_ray_tracer_tpu_torch.parallel.train import trainable_scene
    from opencl_ray_tracer_tpu_torch.ref.tracer import _render_oracle
    from opencl_ray_tracer_tpu_torch.utils import profiling as P
    from opencl_ray_tracer_tpu_torch.utils import tracing

    t_phase = time.perf_counter()
    w, h = 1920, 1080
    ortho = T.legacy_ortho_camera(device=dev)
    pin = T.pinhole_camera((w / 2.0, h / 2.0, 900.0), (w / 2.0, h / 2.0, -85.0),
                           fov_degrees=60.0, width=w, height=h, device=dev)
    headline = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
    stress = T.random_scene(100, 100, seed=0, bounds=(1910.0, 1070.0), device=dev)
    four_k = T.random_scene(100, 100, seed=2, bounds=(3830.0, 2150.0), device=dev)
    hl_cfg = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                            framebuffer_dtype="packed")
    legacy96 = T.RenderConfig(width=w, height=h, shading="legacy", cull_k=96,
                              framebuffer_dtype="packed")
    cfg_4k = legacy96.replace(width=3840, height=2160)
    soft_cfg = _soft_cfg(T, w, h, "phong", True).replace(cull_k=96,
                                                         shadow_cull_k=136)
    hl_packed = headline.pack()

    # ---- the main path, counted -----------------------------------------
    tracing.reset()
    dyn = fwd_tiled.render_tiled_packed(hl_packed, pin, hl_cfg)
    stress_frame = render(stress, ortho, legacy96, backend="pallas")
    frame_4k = render(four_k, ortho, cfg_4k, backend="pallas")
    torch.cuda.synchronize()
    b1, b4 = _hard_launches(tracing), tracing.counter("launch.B4")
    tracing.reset()
    b1_float = render(headline, ortho, hl_cfg.replace(framebuffer_dtype="float"),
                      backend="pallas")
    torch.cuda.synchronize()
    b2 = _hard_launches(tracing)
    s = trainable_scene(stress)
    _mean_sq(S.render_soft_tiled(s, ortho, soft_cfg)).backward()
    torch.cuda.synchronize()
    launches = {"B1": b1, "B2": b2, "B4": b4 + tracing.counter("launch.B4"),
                "B5": tracing.counter("launch.B5")}
    print(f"[new] launches in the main-path run: {launches}")
    _require(all(v >= 1 for v in launches.values()) and b1 >= 3,
             f"phase 13's path did not go through its kernels: {launches}")
    for name, frame, shape in (("dynamic", dyn, (h, w)), ("stress", stress_frame, (h, w)),
                               ("4K", frame_4k, (2160, 3840)),
                               ("float headline", b1_float, (h, w, 4))):
        _require(tuple(frame.shape) == shape, f"[new] {name}: shape {frame.shape}")
    _require(bool(torch.isfinite(b1_float).all()), "[new] non-finite float frame")
    _require(bool(torch.isfinite(s.sphere_origin.grad).all()
                  and (s.sphere_origin.grad != 0).any()),
             "[new] the stress soft step gave no finite gradient")

    # ---- B1 at the new sizes --------------------------------------------
    for label, scene, cfg in (
        ("stress 1080p 100sph+100cubes legacy packed k=96", stress, legacy96),
        ("stress 1080p 100sph+100cubes phong+shadows float k=96", stress,
         legacy96.replace(shading="phong", shadows=True, framebuffer_dtype="float")),
        ("4K 100sph+100cubes legacy packed k=96", four_k, cfg_4k),
        ("4K 100sph+100cubes phong+shadows float k=96", four_k,
         cfg_4k.replace(shading="phong", shadows=True, framebuffer_dtype="float")),
    ):
        _b1_case(label, scene, ortho, cfg, smi)

    # ---- the dynamic frame: re-binned in the call = precomputed bins -----
    bins = fwd_tiled.bin_for_config(hl_packed, pin, hl_cfg)
    static = fwd_tiled.render_tiled_packed(hl_packed, pin, hl_cfg, bins=bins)
    _require(torch.equal(dyn, static), "[new] the dynamic frame differs from "
                                       "the frame with precomputed bins")
    print(f"[new] dynamic frame (headline, pinhole): identical to "
          f"render_tiled_packed with precomputed bins; K caps "
          f"k={max(bins.k_tri, bins.k_sph)} shadow_k={max(bins.k_sh_tri, bins.k_sh_sph)} "
          f"(asked {hl_cfg.cull_k}, {hl_cfg.shadow_cull_k}: escalated "
          f"{bins.k_tri > hl_cfg.cull_k or bins.k_sph > hl_cfg.cull_k})")

    # ---- B4 and B5 on the stress soft step ---------------------------------
    ops = _soft_operands(stress, ortho, soft_cfg)
    kc = ops[4]
    got, tiles = S._soft_tiled_fwd_cuda(*ops[:4], kc)
    with torch.no_grad():
        ferr = (got - S._soft_tiled_plain(*ops[:4], cfg=kc)).abs().max().item()
    _require(ferr < FWD_BAR, f"[new] stress soft B4 vs twin {ferr} >= {FWD_BAR}")
    n_live = _tile_list_vs_plain("[new] stress soft B4", tiles, ops[3])
    sbins = S.soft_bins_for_config(stress.pack(), ortho, soft_cfg)
    k, sk = max(sbins.k_tri, sbins.k_sph), max(sbins.k_sh_tri, sbins.k_sh_sph)
    g = torch.zeros_like(got)
    g[..., :3] = 2.0 * got[..., :3] / (h * w * 3)   # d mean(img^2) / d img
    b4_ms = device_ms(lambda: S.soft_tiled_fwd(*ops[:4], cfg=kc), 20)
    b5_ms = device_ms(lambda: S.soft_tiled_bwd(*ops[:4], g, cfg=kc), 20)
    # the lean B4 and the recomputing B5 timed above, and their bounds
    lean = ops[:4] + (dict(kc, stored_finals=False),)
    b4b, b5b = P.tiled_soft_bounds(stress, ortho, soft_cfg, lean, g)[:2]
    print(f"[new] stress soft 1080p phong+soft shadows: final K caps k={k} "
          f"shadow_k={sk} (asked 96, 136); B4 vs twin {ferr:.5f} (bar {FWD_BAR}) "
          f"on every pixel; {n_live} of {ops[3].shape[0]} tiles non-empty, the "
          f"card's list equals fwd_tiled._live_tiles; device ms per launch: B4 "
          f"{b4_ms:.4f} (bound {b4b[0]:.5f} by {b4b[1]}, {b4_ms / b4b[0]:.1f}x), "
          f"B5 on the loss's cotangent {b5_ms:.4f} (bound {b5b[0]:.5f} by "
          f"{b5b[1]}, {b5_ms / b5b[0]:.1f}x); {smi}")
    del ops, got, g
    # The twin's autograd keeps every intermediate of every tile: at full
    # size it may not fit the card. Then the largest frame that fits, with
    # the same scene and the same K caps (the full frame's final ones).
    for gw, gh in ((w, h), (1280, 720), (960, 540), (640, 480)):
        cfg_g = soft_cfg.replace(width=gw, height=gh, cull_k=k, shadow_cull_k=sk)
        torch.cuda.reset_peak_memory_stats()
        try:
            gt = _leaf_grads(_twin_render, stress, ortho, cfg_g, _mean_sq)
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            print(f"[new] stress soft step at {gw}x{gh}: the twin's autograd does "
                  f"not fit the card's memory")
            continue
        peak = torch.cuda.max_memory_allocated() / 2**30  # the twin's
        gk = _leaf_grads(S.render_soft_tiled, stress, ortho, cfg_g, _mean_sq)
        gerr = _compare_grads(f"[new] stress soft {gw}x{gh}", gk, gt, 1e-3)
        print(f"[new] stress soft step at {gw}x{gh} (K {k}, {sk}): B5 leaf grads "
              f"vs the twin's autograd, normalised max err {gerr:.2e} (bar 1e-3); "
              f"the twin's peak device memory {peak:.1f} GiB")
        break
    else:
        raise RuntimeError("[new] the stress soft twin fits no frame size")
    del gt, gk
    torch.cuda.empty_cache()

    # ---- the whole-frame xla backend on the 1080p headline frame ------------
    for shading, shadows, fmt in (("phong", True, "float"), ("legacy", False, "int")):
        cfg = T.RenderConfig(width=w, height=h, shading=shading, shadows=shadows,
                             framebuffer_dtype=fmt)
        xla = render(headline, ortho, cfg, backend="xla")
        _require(tuple(xla.shape) == (h, w, 4), f"[new] xla frame {xla.shape}")
        oracle = _render_oracle(headline, ortho, cfg)
        tiled = render(headline, ortho, cfg, backend="pallas")
        label = f"[new] xla 1080p headline {shading} {fmt}"
        if fmt == "float":
            _require(bool(torch.isfinite(xla).all()), f"{label}: non-finite")
            _check_twin(f"{label} vs the oracle", xla, oracle, "float")
            close, lit = _lit_agreement(xla, tiled)
            print(f"{label} vs B2: {close:.6f} of the lit pixels within 0.5/255 "
                  f"(bar 0.995, B1's against the oracle); {lit:.4f} lit")
            _require(close >= 0.995 and lit > 0.001, f"{label} vs B2: {close}")
        else:
            for what, other in (("the oracle", oracle), ("B1", tiled)):
                same = (xla == other).all(-1).float().mean().item()
                print(f"{label} vs {what}: {same:.6f} of pixels identical (bar 0.999)")
                _require(same >= 0.999, f"{label} vs {what}: {same}")
        med, lo, hi = _time_ms(lambda: render(headline, ortho, cfg, backend="xla"), 10, 1)
        print(f"[time] {label}: whole render(backend='xla') median {med:.4f} ms "
              f"[{lo:.4f}, {hi:.4f}] over 10 frames; {smi}")
    # `cli render --backend xla` as a user runs it: its PNG is the frame
    import tempfile

    from opencl_ray_tracer_tpu_torch.utils import pack_rgba, read_png

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "scene1_xla.png")
        proc = subprocess.run(
            [sys.executable, "-m", "opencl_ray_tracer_tpu_torch.cli", "render",
             "--scene", "1", "--backend", "xla", "--out", png],
            cwd=root, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": root})
        print(proc.stdout.strip())
        _require(proc.returncode == 0, f"cli render --backend xla failed:\n"
                                       f"{proc.stderr[-4000:]}")
        got = read_png(png)
    cfg = T.RenderConfig(width=640, height=480, shading="legacy",
                         framebuffer_dtype="int")
    want = pack_rgba(render(T.create_scene(1, seed=0, device=dev), ortho, cfg,
                            backend="xla"))
    same = float((got == want).all(-1).mean())
    print(f"[new] cli render --scene 1 --backend xla: its PNG {same:.6f} "
          f"identical to render(backend='xla') (bar 1)")
    _require(same == 1.0, f"cli render --backend xla: {same}")
    print(f"[new] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# The row-sharded path: parallel/{distributed,mesh,dryrun}.py and the mesh
# train step, through B1/B2, B4 and B5
# ---------------------------------------------------------------------------

def _sharded_frames(T, dev, scene, cam, cfg, counted):
    """The frame as 4 ranks render it and as a (2, 2) mesh's 4 ranks render
    it (the same 270-row blocks: rows shard over both axes, host-major), one
    card, block by block: the 4-way split through _render_rows and
    shift_camera_rows, the 2x2 split through render_sharded on each rank's
    view of the mesh. Both counted. Returns (4-way frame, 2x2 frame)."""
    import torch

    from opencl_ray_tracer_tpu_torch.parallel import HOST_AXIS, IMAGE_AXIS, Mesh
    from opencl_ray_tracer_tpu_torch.parallel import render_sharded, shift_camera_rows
    from opencl_ray_tracer_tpu_torch.parallel.mesh import _render_rows

    hl = cfg.height // 4
    flat = counted(lambda: torch.cat([
        _render_rows(scene, shift_camera_rows(cam, r * hl), hl, cfg.width, cfg)
        for r in range(4)]), cfg)
    grid = counted(lambda: torch.cat([
        render_sharded(scene, cam, cfg, mesh=Mesh((2, 2), (HOST_AXIS, IMAGE_AXIS),
                                                  rank=r, device=dev))
        for r in range(4)]), cfg)
    return flat, grid


def sharded_phase(T, dev, smi):
    """Phase 14: the row-sharded path on the card. (a) distributed.initialize
    at world size 1 over NCCL; (b) the dryrun_multichip body (parallel/
    dryrun.py) at world size 1, its loss against the unsharded step's; (c)
    phase 9's 1080p train step through make_train_step(..., adam(...),
    mesh=make_mesh(1)), 3 steps, each against the unsharded step from the
    same state (losses and scene within rtol 1e-6), both timed, and the
    all-reduce alone; (d) the
    headline 1080p frame as 4 blocks of 270 rows and as 2x2 blocks, against
    the unsharded frame: packed words (B1, ortho and pinhole) >= 99.5%
    identical, the float frame (B2) >= 99.5% of pixels within 0.5/255,
    `xla` identical, soft (B4) >= 99.9% of pixels within 0.05/255; the last
    block through B2 and every block through B4 against their twins; the
    sum of the 4 blocks' scene-leaf gradients (B5, each block's loss over
    the whole frame's pixels) within 1e-3 normalised of the same blocks
    through the twin and within 5e-3 of the unsharded gradients. Every sharded call is counted (the
    counts set to 0 just before it and read just after); the unsharded
    references and the twins are not. Returns the launches per kernel."""
    import torch
    import torch.distributed as dist

    from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
    from opencl_ray_tracer_tpu_torch.models.renderer import render
    from opencl_ray_tracer_tpu_torch.parallel import (
        adam,
        distributed,
        init_train_state,
        make_mesh,
        make_train_step,
        replicate,
        scene_leaves,
        shard_rows,
        shift_camera_rows,
    )
    from opencl_ray_tracer_tpu_torch.parallel.dryrun import dryrun_body
    from opencl_ray_tracer_tpu_torch.parallel.mesh import _render_rows
    from opencl_ray_tracer_tpu_torch.utils import tracing

    t_phase = time.perf_counter()
    launches = {"B1": 0, "B2": 0, "B4": 0, "B5": 0}

    def counted(fn, cfg=None):
        tracing.reset()
        out = fn()
        torch.cuda.synchronize()
        hard = "B1" if cfg is not None and cfg.framebuffer_dtype == "packed" else "B2"
        launches[hard] += _hard_launches(tracing)
        launches["B4"] += tracing.counter("launch.B4")
        launches["B5"] += tracing.counter("launch.B5")
        return out

    # ---- (a) the process group: one rank over NCCL ------------------------
    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0)
    backend = dist.get_backend()
    print(f"[sharded] process group: world size {dist.get_world_size()}, rank "
          f"{dist.get_rank()}, backend {backend}, device {distributed.local_device()}")
    _require(backend == "nccl", f"[sharded] backend {backend}, not nccl")

    try:
        # ---- (b) the dryrun body at world size 1 --------------------------
        before = dict(launches)
        loss_b = counted(lambda: dryrun_body(1))
        got = {k: launches[k] - before[k] for k in ("B4", "B5")}
        cam = T.legacy_ortho_camera(device=dev)
        cfg = T.RenderConfig(width=128, height=8, shading="phong", shadows=True,
                             soft=True, framebuffer_dtype="float")
        opt = adam(1e-2)
        ref = make_train_step(cam, cfg, opt)(
            init_train_state(T.create_scene1(device=dev), opt),
            torch.zeros((8, 128, 4), device=dev))[1].item()
        print(f"[sharded] dryrun body at world size 1: loss {loss_b:.9f}, the "
              f"unsharded step's {ref:.9f}; launches {got}")
        _require(loss_b == loss_b and abs(loss_b) != float("inf"),
                 f"[sharded] dryrun loss {loss_b}")
        _require(abs(loss_b - ref) <= 1e-6 * abs(ref), "[sharded] dryrun loss "
                 f"{loss_b} is not the unsharded step's {ref}")
        _require(got["B4"] >= 1 and got["B5"] >= 1, f"[sharded] dryrun launches {got}")

        # ---- (c) the 1080p train step on a one-rank mesh -------------------
        w, h = 1920, 1080
        headline = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
        soft = _soft_cfg(T, w, h, "phong", True)
        target = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
        mesh = make_mesh(1)
        opt_u, opt_m = adam(1e-3), adam(1e-3)
        step_u = make_train_step(cam, soft, opt_u)
        step_m = make_train_step(cam, soft, opt_m, mesh=mesh)
        state_u = init_train_state(headline, opt_u)
        state_m = init_train_state(replicate(headline, mesh), opt_m)
        tgt_m = shard_rows(target, mesh)
        # In lockstep: before each step the unsharded state takes the mesh
        # state's scene and Adam moments, so each pair of steps starts from
        # the same state (B5 sums with atomic adds: two runs of the same
        # steps drift apart in the last bits, printed below).
        losses_u, losses_m, lerr, serr = [], [], 0.0, 0.0
        for _ in range(3):
            with torch.no_grad():
                for a, b in zip(scene_leaves(state_u.scene).values(),
                                scene_leaves(state_m.scene).values()):
                    a.copy_(b)
            state_u.opt_state.load_state_dict(
                copy.deepcopy(state_m.opt_state.state_dict()))
            state_u, lu = step_u(state_u, target)
            state_m, lm = counted(lambda: step_m(state_m, tgt_m))
            losses_u.append(lu.item())
            losses_m.append(lm.item())
            lerr = max(lerr, abs(lm.item() - lu.item()) / abs(lu.item()))
            serr = max(serr, max(
                ((scene_leaves(state_m.scene)[k] - v).abs()
                 / v.abs().clamp_min(1e-30)).max().item()
                for k, v in scene_leaves(state_u.scene).items()))
        print(f"[sharded] 1080p train step, 3 steps on make_mesh(1) vs the "
              f"unsharded step from the same state: losses {losses_m} vs "
              f"{losses_u} (largest relative difference {lerr:.2e}), scene after "
              f"each step: largest relative difference {serr:.2e} (bar 1e-6)")
        _require(lerr <= 1e-6 and serr <= 1e-6, "[sharded] the mesh step is "
                 f"not the unsharded step: {lerr}, {serr}")
        drift = []
        for _ in range(2):
            opt = adam(1e-3)
            st = init_train_state(headline, opt)
            drift.append([step_u(st, target)[1].item() for _ in range(3)])
        print(f"[sharded] two runs of 3 unsharded steps from one start: losses "
              f"{drift[0]} and {drift[1]} (largest relative difference "
              f"{max(abs(a - b) / abs(a) for a, b in zip(*drift)):.2e})")
        runs = {"unsharded": (None, state_u, step_u, target),
                "mesh": (None, state_m, step_m, tgt_m)}
        times = {label: _time_ms(lambda r=r: r[2](r[1], r[3]), 20, 2)
                 for label, r in runs.items()}
        n_grad = sum(v.numel() for v in scene_leaves(state_m.scene).values()) + 1
        buf = torch.zeros(n_grad, device=dev)
        ar = _time_ms(lambda: mesh.all_reduce(buf), 100)
        for label, (med, lo, hi) in times.items():
            print(f"[time] [sharded] train 1080p phong+soft shadows, {label} step: "
                  f"median {med:.4f} ms [{lo:.4f}, {hi:.4f}] over 20; {smi}")
        print(f"[time] [sharded] the all-reduce of the step's {n_grad} floats alone "
              f"(NCCL, one rank): median {ar[0]:.4f} ms [{ar[1]:.4f}, {ar[2]:.4f}] "
              f"over 100; step difference {times['mesh'][0] - times['unsharded'][0]:+.4f} "
              f"ms; {smi}")

        # ---- (d) the frame block by block ---------------------------------
        pin = T.pinhole_camera((w / 2.0, h / 2.0, 900.0), (w / 2.0, h / 2.0, -85.0),
                               fov_degrees=60.0, width=w, height=h, device=dev)
        packed = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                                framebuffer_dtype="packed")
        cases = (
            ("B1 packed ortho", cam, packed, "words"),
            ("B1 packed pinhole", pin, packed, "words"),
            ("B2 float ortho", cam, packed.replace(framebuffer_dtype="float"), "float"),
            ("B4 soft ortho", cam, soft, "soft"),
            ("xla float ortho", cam, packed.replace(framebuffer_dtype="float",
                                                    backend="xla"), "identical"),
        )
        for label, cam_, cfg_, bar in cases:
            flat, grid = _sharded_frames(T, dev, headline, cam_, cfg_, counted)
            with torch.no_grad():
                full = render(headline, cam_, cfg_)
            _require(torch.equal(flat, grid), f"[sharded] {label}: the 2x2 blocks "
                                              "differ from the 4-way blocks")
            _require(tuple(flat.shape) == tuple(full.shape), f"[sharded] {label}: "
                     f"{tuple(flat.shape)}")
            if bar == "words":
                share = (flat == full).float().mean().item()
                msg = f"{share:.6f} of words identical (bar 0.995)"
                ok = share >= 0.995
            elif bar == "float":
                err = _errors(flat, full, "float")
                share = (err < 0.5).float().mean().item()
                msg = (f"{share:.6f} of pixels within 0.5/255 (bar 0.995), max err "
                       f"{err.max().item():.4f}")
                ok = share >= 0.995
            elif bar == "soft":
                # Two tilings of the reference's tiled soft function, held as
                # phase 12 holds two formulations: its frame depends on the
                # tile grid (scripts/torch_soft_tiling.py)
                err = (flat - full).abs().amax(-1)
                share = (err < FWD_BAR).float().mean().item()
                msg = (f"{share:.6f} of pixels within {FWD_BAR}/255 (bar 0.999), "
                       f"max err {err.max().item():.5f}, "
                       f"{(err > 1e-2).sum().item()} pixels over 1e-2")
                ok = share >= 0.999
            else:
                ok = torch.equal(flat, full)
                msg = f"identical: {ok}"
            print(f"[sharded] 1080p headline {label}, 4 blocks of 270 rows (= 2x2 "
                  f"blocks, identical) vs the unsharded frame: {msg}")
            _require(ok, f"[sharded] {label}: {msg}")

        # the blocks through the kernels against their twins: B2 on the last
        # block (rows 810-1079: tile rows not on the frame's), B4 on each
        last = shift_camera_rows(cam, 810)
        fcfg = packed.replace(height=270, framebuffer_dtype="float")
        pk = headline.pack()
        bins = fwd_tiled.bin_for_config(pk, last, fcfg)
        args, kw = fwd_tiled.kernel_inputs(pk, last, bins, height=270, width=w,
                                           shading="phong", shadows=True,
                                           out_format="float")
        _check_twin("[sharded] last block, B2 vs twin", fwd_tiled.tiled_kernel(*args, **kw),
                    fwd_tiled._tiled_kernel_plain(*args, **kw), "float")
        block_cfg = soft.replace(height=270)
        for r in range(4):
            ops = _soft_operands(headline, shift_camera_rows(cam, r * 270), block_cfg)
            with torch.no_grad():
                ferr = (S.soft_tiled_fwd(*ops[:4], cfg=ops[4])
                        - S._soft_tiled_plain(*ops[:4], cfg=ops[4])).abs().max().item()
            print(f"[sharded] block {r}, B4 vs twin: max err {ferr:.5f} (bar {FWD_BAR})")
            _require(ferr < FWD_BAR, f"[sharded] block {r} B4 vs twin {ferr}")

        # the 4 blocks' gradients, summed: against the same blocks through the
        # twin (B5 on these inputs, phase 7's bar) and against the unsharded
        # gradients (two tilings: phase 12's bar for two formulations)
        inv_npix = 1.0 / (h * w * 3.0)
        loss_fn = lambda img: ((img[..., :3] * (1.0 / 255.0)) ** 2).sum() * inv_npix  # noqa: E731

        def block_grads(render_block):
            total = None
            for r in range(4):
                g = _leaf_grads(lambda s, c, cf, r=r: render_block(
                    s, shift_camera_rows(c, r * 270), cf.replace(height=270)),
                    headline, cam, soft, loss_fn)
                total = g if total is None else {k: total[k] + g[k] for k in g}
            return total

        got = counted(lambda: block_grads(
            lambda s, c, cf: _render_rows(s, c, cf.height, cf.width, cf)))
        terr = _compare_grads("[sharded] B5 4 blocks vs twin", got,
                              block_grads(_twin_render), 1e-3)
        want = _leaf_grads(S.render_soft_tiled, headline, cam, soft, loss_fn)
        gerr = _compare_grads("[sharded] B5 4 blocks vs unsharded", got, want, 5e-3,
                              lost_floor=5e-3)
        print(f"[sharded] the sum of the 4 blocks' scene-leaf gradients: vs the "
              f"same blocks through the twin, normalised max err {terr:.2e} (bar "
              f"1e-3); vs the unsharded step's {gerr:.2e} (bar 5e-3)")

        # the 4-block frame's time against the unsharded frame's
        for label, cfg_ in (("B1 packed ortho", packed), ("B4 soft ortho", soft)):
            def blocks(cfg_=cfg_):
                with torch.no_grad():
                    for r in range(4):
                        _render_rows(headline, shift_camera_rows(cam, r * 270), 270,
                                     w, cfg_)

            def whole(cfg_=cfg_):
                with torch.no_grad():
                    render(headline, cam, cfg_)

            tb, tw = _time_ms(blocks, 20), _time_ms(whole, 20)
            print(f"[time] [sharded] 1080p headline {label}: 4 blocks one after "
                  f"another median {tb[0]:.4f} ms [{tb[1]:.4f}, {tb[2]:.4f}], the "
                  f"unsharded frame {tw[0]:.4f} ms [{tw[1]:.4f}, {tw[2]:.4f}], over "
                  f"20; {smi}")
    finally:
        dist.destroy_process_group()
    print(f"[sharded] launches of the sharded calls: {launches}")
    _require(all(v >= 1 for v in launches.values()),
             f"phase 14's path did not go through its kernels: {launches}")
    print(f"[sharded] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# The app shell: cli compare, cli app, the two examples (through B2, B4, B5)
# ---------------------------------------------------------------------------

def _example(name):
    """examples/<name>.py of this checkout, imported as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cli(argv):
    """The port's CLI in this process, as a user runs it: (exit code,
    stdout). It runs in this process so that the launch counts see it."""
    import contextlib
    import io

    from opencl_ray_tracer_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    print("\n".join(f"    | {line}" for line in out.strip().splitlines()[-24:]))
    return rc, out


def shell_phase(T, dev, smi):
    """Phase 15: the app shell on the card, through the entry points a user
    calls, each counted (the counts set to 0 just before and read just
    after). (a) `cli compare` on scenes 1 and 2 at 640x480 legacy and on
    scene 1 at 1920x1080 phong + shadows: exit 0 and OK, the CPU leg on
    the CPU, both times and the speedup; (b) `cli app --keys` over the
    three backends and scenes 1-3 at 640x480 with a PNG of every frame:
    each pallas frame identical to the same scene's reference frame on >
    99.9% of pixels (compare's bar), each xla frame on >= 99.9% (phase
    13's); (c) examples/torch_flythrough_demo.py at its defaults (1280x720,
    60 frames, phong + shadows, pinhole), frame 0 through B2 against the
    twin at the hard bars; (d) examples/torch_inverse_rendering_demo.py at
    its defaults on one card: the loss falls; (e) the memory report shows
    bytes in use on the card, the platform report names it. Returns the
    launches of its main path per kernel."""
    import contextlib
    import re
    import tempfile

    import numpy as np
    import torch

    from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
    from opencl_ray_tracer_tpu_torch.utils import memory, platform_info, read_png
    from opencl_ray_tracer_tpu_torch.utils import tracing

    t_phase = time.perf_counter()
    launches = {"B1": 0, "B2": 0, "B4": 0, "B5": 0}

    def counted(fn, hard="B2"):
        tracing.reset()
        out = fn()
        torch.cuda.synchronize()
        got = {hard: _hard_launches(tracing), "B4": tracing.counter("launch.B4"),
               "B5": tracing.counter("launch.B5")}
        for k, v in got.items():
            launches[k] += v
        return out, got

    # ---- (a) cli compare ---------------------------------------------------
    card = torch.cuda.get_device_name(0)
    for argv in (["--scene", "1"], ["--scene", "2"],
                 ["--scene", "1", "--width", "1920", "--height", "1080",
                  "--shading", "phong", "--shadows"]):
        t0 = time.perf_counter()
        (rc, out), got = counted(lambda: _cli(["compare", *argv]))
        cpu = re.search(r"CPU \(reference\) \[(\S+)\]:\s+(\d+) us", out)
        acc = re.search(r"pallas \[(\S+) ([^\]]+)\]:\s+(\d+) us", out)
        speed = re.search(r"speedup: (\S+)x", out)
        check = re.search(r"cross-check: (.*) -> (OK|MISMATCH)", out)
        label = f"[shell] cli compare {' '.join(argv)}"
        _require(rc == 0 and check and check.group(2) == "OK",
                 f"{label}: exit {rc}, {check and check.group(0)}")
        _require(cpu and cpu.group(1) == "cpu", f"{label}: the CPU leg ran on "
                 f"{cpu and cpu.group(1)}")
        _require(acc and acc.group(1) == "cuda:0" and acc.group(2) == card,
                 f"{label}: the accelerated leg ran on {acc and acc.group(0)}")
        _require(got["B2"] >= 43, f"{label}: B2 launched {got['B2']} times")
        print(f"{label}: exit {rc}, {check.group(1)} -> OK; CPU leg on "
              f"{cpu.group(1)} {int(cpu.group(2))} us, pallas on {acc.group(1)} "
              f"{int(acc.group(3))} us (time_fn medians), speedup {speed.group(1)}x; "
              f"{got['B2']} B2 launches; {time.perf_counter() - t0:.1f} s; {smi}")

    # ---- (b) cli app --keys ------------------------------------------------
    # r: pallas scene 1; m: reference; m: xla; s: scene 2 (xla); m: pallas;
    # m: reference; s: scene 3 (reference: 1,300 primitives, the slow CPU
    # frame, once); m: xla; m: pallas; p after every frame
    keys = "r,p,m,p,m,p,s,p,m,p,m,p,s,p,m,p,m,p,q"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        (rc, out), got = counted(lambda: _cli(["app", "--keys", keys]))
        _require(rc == 0, f"[shell] cli app exit {rc}")
        pngs = {}
        for num in (1, 2, 3):
            for backend in ("reference", "xla", "pallas"):
                name = f"scene{num}_{backend}.png"
                _require(os.path.exists(name), f"[shell] cli app wrote no {name}")
                pngs[num, backend] = read_png(name)
    modes = set(re.findall(r"Mode: (\w+) .*\| Scene (\d)", out))
    _require(len(modes) == 9, f"[shell] cli app reached {sorted(modes)}")
    _require(got["B2"] >= 3, f"[shell] cli app: B2 launched {got['B2']} times")
    for num in (1, 2, 3):
        ref = pngs[num, "reference"]
        _require(ref.shape == (480, 640, 4), f"[shell] scene {num}: {ref.shape}")
        for backend, bar in (("pallas", "> 0.999"), ("xla", ">= 0.999")):
            same = float((pngs[num, backend] == ref).all(-1).mean())
            ok = same > 0.999 if backend == "pallas" else same >= 0.999
            print(f"[shell] cli app scene {num} 640x480 legacy: {backend} frame "
                  f"vs the reference (CPU) frame, {same:.6f} of pixels identical "
                  f"(bar {bar})")
            _require(ok, f"[shell] cli app scene {num} {backend}: {same}")
    print(f"[shell] cli app --keys {keys}: 9 frames over 3 backends x 3 scenes, "
          f"9 PNGs; {got['B2']} B2 launches; {time.perf_counter() - t0:.1f} s")

    # ---- (c) the flythrough at its defaults --------------------------------
    fly = _example("torch_flythrough_demo")
    res, got = counted(lambda: fly.main([]))
    _require(got["B2"] >= 61 and res["frames"] == 60,
             f"[shell] flythrough: {res}, launches {got}")
    scene, cfg, camera_at = fly.setup(fly.parse_args([]))
    packed, cam0 = scene.pack(), camera_at(0.0)
    bins = fwd_tiled.bin_for_config(packed, cam0, cfg)
    args, kw = fwd_tiled.kernel_inputs(
        packed, cam0, bins, height=cfg.height, width=cfg.width,
        shading=cfg.shading, shadows=cfg.shadows, out_format=cfg.framebuffer_dtype)
    err = _check_twin("[shell] flythrough frame 0 1280x720 phong+shadows pinhole, "
                      "B2 vs twin", fwd_tiled.tiled_kernel(*args, **kw),
                      fwd_tiled._tiled_kernel_plain(*args, **kw), "float")
    # a frame off the demo's orbit, replayed from the graph its loop captured
    cam1 = camera_at(1.0)
    tracing.reset()
    replayed = fwd_tiled.render_tiled(scene, cam1, cfg)
    torch.cuda.synchronize()
    _require(tracing.counter("graph.replays.render_tiled") >= 1
             and tracing.counter("frame.replayed") == 1,
             "[shell] the flythrough's frame did not replay its graph")
    bins = fwd_tiled.bin_for_config(packed, cam1, cfg)
    args, kw = fwd_tiled.kernel_inputs(
        packed, cam1, bins, height=cfg.height, width=cfg.width,
        shading=cfg.shading, shadows=cfg.shadows, out_format=cfg.framebuffer_dtype)
    rerr = _check_twin("[shell] flythrough replayed frame 1280x720 phong+shadows "
                       "pinhole, B2 vs twin", replayed,
                       fwd_tiled._tiled_kernel_plain(*args, **kw), "float")
    _require(torch.equal(replayed, fwd_tiled.tiled_kernel(*args, **kw)),
             "[shell] the flythrough's replayed frame is not B2's on the same bins")
    print(f"[shell] flythrough (defaults): {res['frames']} frames at 1280x720 in "
          f"{res['seconds']:.3f} s, {res['fps']:.1f} fps, "
          f"{res['fps'] * 1280 * 720:.3e} rays/s (host clock, a fence a frame); "
          f"{got['B2']} B2 launches; frame 0 vs twin max err {err:.4f}, a "
          f"replayed frame {rerr:.4f}; {smi}")

    # ---- (d) the inverse-rendering demo at its defaults ----------------------
    inv = _example("torch_inverse_rendering_demo")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res, got = counted(lambda: inv.main(["--out-prefix",
                                             os.path.join(tmp, "inv")]))
        _require(all(os.path.exists(os.path.join(tmp, f"inv_{p}.png"))
                     for p in ("target", "init", "fitted")), "[shell] inverse demo PNGs")
    losses = res["losses"]
    # fit_scene runs the compiled step: B4 and B5 launch through their
    # wrappers at the graph's two warm-up calls and its capture; the other
    # 147 steps replay the same launches with no wrapper call (uncounted),
    # and the falling loss is their work
    _require(got["B4"] >= 3 and got["B5"] >= 3,
             f"[shell] inverse demo launches {got}")
    _require(all(np.isfinite(losses)) and losses[-1] < losses[0],
             f"[shell] inverse demo losses {losses}")
    print(f"[shell] inverse demo (defaults, 256x128, 150 steps, one card): loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}; B4 {got['B4']}, B5 {got['B5']} "
          f"launches; {time.perf_counter() - t0:.1f} s; {smi}")

    # ---- (e) memory and platform reports ----------------------------------
    report = memory.format_memory_report()
    print("[shell] memory report: " + report.replace("\n", "; "))
    in_use = re.search(r"cuda:0: ([\d.]+) MB in use / ([\d.]+) MB", report)
    _require(in_use and float(in_use.group(1)) > 0,
             f"[shell] the memory report shows nothing in use on the card: {report}")
    info = platform_info.system_info()
    print(f"[shell] platform: backend {info['backend']}, devices {info['devices']}, "
          f"torch {info['torch']}, cuda {info['cuda']}")
    _require(info["backend"] == "gpu" and f"gpu:{card}#0" in info["devices"],
             f"[shell] the platform report does not name the card: {info}")
    print(f"[shell] launches of the shell's calls: {launches}")
    print(f"[shell] phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return launches



# ---------------------------------------------------------------------------
# The compiled path: the JAX package's jit forms as CUDA graphs
# ---------------------------------------------------------------------------

GRAPH_KERNELS = ("B1", "B2", "B3", "B4", "B5", "B6", "B7")


# The kernels' launch counters (`utils.tracing`): B1 and B2 share launch.B1,
# told apart by the frame's format.
GRAPH_COUNTERS = ("B1", "B3", "B4", "B5", "B6", "B7")


def _copy_train_state(src, dst):
    """dst's parameters and Adam state <- src's, in place (a captured step
    keeps their addresses)."""
    import torch

    from opencl_ray_tracer_tpu_torch.parallel.train import scene_leaves

    with torch.no_grad():
        for a, b in zip(scene_leaves(src.scene).values(),
                        scene_leaves(dst.scene).values()):
            b.copy_(a)
            sa, sb = src.opt_state.state.get(a, {}), dst.opt_state.state.get(b, {})
            for k, v in sb.items():
                if isinstance(v, torch.Tensor):
                    v.copy_(sa[k])


# Which branch a replay runs, from a profiler trace of one replay. A trace of
# a replay names the kernels inside conditional nodes wrongly once a process
# holds graphs of several shapes (torch 2.11, CUDA 12.8, an H100: the
# soft step's B5 read as B1/B2 and B3 after the hard frames' graphs, or went
# missing; eager module loading did not help), so each case is captured,
# replayed and traced in a process of its own, four at a time.
BRANCH_CASES = {
    16: ("entry", "entry-k8", "headline-packed", "headline-packed-k8",
         "headline-float", "dynamic", "dynamic-k8", "soft-k8", "train1080"),
    17: ("mesh-1", "mesh-1x1", "sharded-packed", "sharded-float", "sharded-k8",
         "sharded-soft", "fit"),
}


def _branch_case(name, T, dev):
    """(replay_fn, eager_fn, overflow, soft, grads) of one compiled case of
    phases 16 and 17, built as they build it: replay_fn calls the compiled
    form (its first call captures), eager_fn the eager call of the same
    work, overflow the bins' flag read on the host (the brute branch's
    case), soft whether the cond is the soft one and grads whether the
    replay runs its backward too."""
    import torch

    from opencl_ray_tracer_tpu_torch.diff import render_soft
    from opencl_ray_tracer_tpu_torch.entry import entry
    from opencl_ray_tracer_tpu_torch.kernels import fwd, fwd_tiled
    from opencl_ray_tracer_tpu_torch.kernels import soft as B
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
    from opencl_ray_tracer_tpu_torch.models.inverse import (
        SPHERE_PARAMS,
        param_filter_from_names,
        perturb_scene,
    )
    from opencl_ray_tracer_tpu_torch.models.renderer import render_jit
    from opencl_ray_tracer_tpu_torch.ops.shading import pack_framebuffer_words
    from opencl_ray_tracer_tpu_torch.parallel import (
        adam,
        distributed,
        init_train_state,
        make_mesh,
        make_mesh_2d,
        make_train_step,
        render_sharded,
        render_sharded_jit,
        replicate,
        shard_rows,
    )
    from opencl_ray_tracer_tpu_torch.parallel.train import (
        scene_leaves,
        step_taus,
        trainable_scene,
    )
    from opencl_ray_tracer_tpu_torch.runtime.graph import jit

    w, h = 1920, 1080
    ortho = T.legacy_ortho_camera(device=dev)
    headline = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
    hl_cfg = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                            framebuffer_dtype="packed")
    soft_cfg = _soft_cfg(T, w, h, "phong", True)
    base = name.removesuffix("-k8")

    def hard(fn, scene, cam, cfg):
        packed = scene.pack()
        flag = bool(fwd_tiled.bin_fixed(packed, cam, cfg).overflow)
        if flag:
            eager = lambda: pack_framebuffer_words(fwd.render_pallas_packed(  # noqa: E731
                packed, cam, cfg.replace(framebuffer_dtype="float")))
        else:
            eager = lambda: fwd_tiled.render_tiled_packed(packed, cam, cfg)  # noqa: E731
        return lambda: fn(scene, cam), eager, flag, False, False

    def steps(cfg, scene, mesh=None, target=None, lr=1e-3, **kw):
        target = torch.zeros((cfg.height, cfg.width, 4), device=dev) \
            if target is None else target
        place = (lambda x: x) if mesh is None else (lambda x: replicate(x, mesh))
        tgt = target if mesh is None else shard_rows(target, mesh)
        opt_e, opt_j = adam(lr), adam(lr)
        step_e = make_train_step(ortho, cfg, opt_e, mesh=mesh, **kw)
        step_j = make_train_step(ortho, cfg, opt_j, mesh=mesh, jit=True, **kw)
        state_e = init_train_state(place(scene), opt_e)
        state_j = init_train_state(place(scene), opt_j)
        flag = bool(S._bin_soft(scene.pack(), cfg.tau_edge, ortho, height=cfg.height,
                                width=cfg.width, k=cfg.cull_k, shadows=cfg.shadows,
                                shadow_k=cfg.shadow_cull_k).overflow)
        return (lambda: step_j(state_j, tgt), lambda: step_e(state_e, tgt), flag,
                True, True)

    if base in ("entry", "headline-packed", "headline-float", "dynamic"):
        if base == "entry":
            fn, (scene, cam) = entry()
            cfg = T.RenderConfig(width=640, height=480, shading="phong",
                                 shadows=True, framebuffer_dtype="packed")
        else:
            scene, cam = headline, ortho
            cfg = hl_cfg.replace(framebuffer_dtype="float") \
                if base == "headline-float" else hl_cfg
            if base == "dynamic":
                cam = T.pinhole_camera((w / 2.0, h / 2.0, 900.0),
                                       (w / 2.0, h / 2.0, -85.0), fov_degrees=60.0,
                                       width=w, height=h, device=dev)
            bins = fwd_tiled.bin_for_config(scene.pack(), cam, cfg)
            cfg = cfg.replace(cull_k=max(bins.k_tri, bins.k_sph),
                              shadow_cull_k=max(bins.k_sh_tri, bins.k_sh_sph, 8))
            fn = render_jit(cfg)
        if name.endswith("-k8"):
            cfg = cfg.replace(cull_k=8, shadow_cull_k=8)
            fn = render_jit(cfg)
        return hard(fn, scene, cam, cfg)
    if name == "soft-k8":
        taus = step_taus(soft_cfg, dev)

        def fwd_bwd(render):
            def run(scene, cam):
                s = trainable_scene(scene)
                leaves = scene_leaves(s)
                img = render(s, cam)
                grads = torch.autograd.grad(_mean_sq(img), list(leaves.values()),
                                            allow_unused=True)
                return img.detach(), [torch.zeros_like(v) if g is None else g
                                      for v, g in zip(leaves.values(), grads)]
            return run

        compiled = jit(fwd_bwd(lambda s, c: S._soft_tiled_core(
            s.pack(), c, *taus, h, w, "phong", True, 8, 8)))
        eager = fwd_bwd(lambda s, c: B._soft_render_core(
            s.pack(), c, *taus, h, w, "phong", True, False))
        flag = bool(S._bin_soft(headline.pack(), 0.5, ortho, height=h, width=w,
                                k=8, shadows=True, shadow_k=8).overflow)
        return (lambda: compiled(headline, ortho), lambda: eager(headline, ortho),
                flag, True, True)
    if name == "train1080":
        return steps(soft_cfg, headline)
    # phase 17: one rank of an NCCL group
    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0)
    if name in ("mesh-1", "mesh-1x1"):
        return steps(soft_cfg, headline,
                     make_mesh(1) if name == "mesh-1" else make_mesh_2d(1, 1))
    if name.startswith("sharded"):
        mesh = make_mesh(1)
        cfg = {"sharded-packed": hl_cfg, "sharded-k8": hl_cfg.replace(
            cull_k=8, shadow_cull_k=8), "sharded-float": hl_cfg.replace(
            framebuffer_dtype="float"), "sharded-soft": soft_cfg}[name]
        fn = render_sharded_jit(cfg, mesh)
        if name != "sharded-soft":
            return hard(lambda s, c: fn(s, c), headline, ortho, cfg)
        flag = bool(S._bin_soft(headline.pack(), 0.5, ortho, height=h, width=w,
                                k=cfg.cull_k, shadows=True,
                                shadow_k=cfg.shadow_cull_k).overflow)

        def eager():
            with torch.no_grad():
                return render_sharded(headline, ortho, cfg, mesh=mesh)

        return lambda: fn(headline, ortho), eager, flag, True, False
    if name == "fit":
        fit_cfg = T.RenderConfig(width=640, height=480, shading="lambert",
                                 soft=True, framebuffer_dtype="float",
                                 tau_depth=1.0, tau_edge=0.5)
        true_scene = T.create_scene(1, seed=0, device=dev)
        with torch.no_grad():
            target = render_soft(true_scene, ortho, fit_cfg)
        return steps(fit_cfg, perturb_scene(true_scene, seed=1), make_mesh(),
                     target, lr=0.5,
                     param_filter=param_filter_from_names(SPHERE_PARAMS))
    raise ValueError(f"no compiled case {name!r}")


def branch_case_main(name):
    """`python3 chip_smoke.py --branch-case NAME`: build one compiled case
    (`_branch_case`), trace one replay and time the replay and the eager
    call (torch.profiler), print one JSON line."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import opencl_ray_tracer_tpu_torch as T
    from opencl_ray_tracer_tpu_torch.utils import profiling as P

    dev = torch.device("cuda", 0)
    try:
        replay_fn, eager_fn, flag, soft, grads = _branch_case(name, T, dev)
        names = P.trace_ops(replay_fn)
        rep, eag = P.device_profile(replay_fn, 5), P.device_profile(eager_fn, 5)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(dict(
        case=name, overflow=flag, soft=soft, grads=grads, ops=len(names),
        kernels=sorted(P.kernels_in(names)),
        own=sorted({n[:80] for n in names if "at::native" not in n}),
        replay_ops=rep[0], replay_ms=rep[2], eager_ops=eag[0], eager_ms=eag[2])))
    return 0


def _branch_traces(phase, tag):
    """The compiled cases of a phase (BRANCH_CASES), each traced in a
    process of its own: one replay holds the kernels of the branch of
    `lax.cond` that its flag takes and none of the other branch's (hard:
    B1/B2 tiled, B3 brute; soft: B4 and, with gradients, B5 tiled, B6 and
    B7 brute); prints its device operations and device ms a replay (the
    union of its operations' intervals, 5 calls) beside the eager call's.
    Returns {case: result}."""
    from concurrent.futures import ThreadPoolExecutor

    def run(name):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--branch-case", name],
            capture_output=True, text=True, timeout=300)
        _require(proc.returncode == 0, f"{tag} branch case {name} failed "
                 f"({proc.returncode}): {proc.stderr[-2000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1])

    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(run, BRANCH_CASES[phase]))
    for r in results:
        _require(r["overflow"] == r["case"].endswith("k8"),
                 f"{tag} {r['case']}: overflow flag {r['overflow']}")
        tiled = ("B4", "B5")[:1 + r["grads"]] if r["soft"] else ("B1/B2",)
        brute = ("B6", "B7")[:1 + r["grads"]] if r["soft"] else ("B3",)
        taken, other = (brute, tiled) if r["overflow"] else (tiled, brute)
        seen = set(r["kernels"])
        print(f"{tag} [branch] {r['case']}: overflow {r['overflow']}, one replay "
              f"traced in its own process: {r['ops']} device operations, the "
              f"{'brute' if r['overflow'] else 'tiled'} branch's {'/'.join(taken)} "
              f"present {set(taken) <= seen}, the other branch's "
              f"{'/'.join(other)} absent {not seen & set(other)}; replay "
              f"{r['replay_ops']:.1f} device operations, {r['replay_ms']:.4f} "
              f"busy ms a call; eager {r['eager_ops']:.1f}, {r['eager_ms']:.4f} "
              f"busy ms")
        _require(set(taken) <= seen and not seen & set(other),
                 f"{tag} {r['case']}: a replay ran {sorted(seen)}; the branch "
                 f"taken needs {taken} and excludes {other}; its operations "
                 f"other than PyTorch's own: {r['own']}")
    return {r["case"]: r for r in results}


def graph_phase(T, dev, smi):
    """Phase 16: the compiled path, the JAX package's `jit` forms as CUDA
    graphs (runtime/graph.py), on one card. Its main path runs with every
    count set to 0 just before each call and read just after: `entry()`,
    the 1080p headline frame (packed and float) and the dynamic pinhole
    frame through `render_jit`, each captured at its first call and replayed
    with the camera moved at every replay; the same frames with cull_k 8,
    below what their tiles hold; the soft frame (`_soft_tiled_core`) at
    cull_k 8 with its gradients; five `make_train_step(jit=True)` train1080
    steps. (a) every replayed hard frame equals the eager
    `render_tiled_packed` word for word (bit for bit for float) at the same
    K caps, and at cull_k 8 the overflow flag is set and the frame equals
    the eager brute frame (`render_pallas_packed`, packed on the card) word
    for word; (b) the soft frame at cull_k 8 within 0.05/255 of the eager
    `_soft_render_core` and its leaf gradients within 1e-3 normalised, then
    each train step within 1e-6 (loss and every leaf, relative) of the eager
    step from the same state; then each compiled case of (a) and (b),
    built again in a process of its own, has one replay traced: it holds
    the kernels of the branch taken and none of the other branch's
    (`_branch_traces`: a replay runs one branch of each `cond`); (c) eager
    and replay per-call medians (CUDA events), device
    kernels and busy share a call (torch.profiler), and the JAX bench's
    slope (`device_frame_time_us` / `device_step_time_us`).
    Returns the launches of its main path per kernel, and the times."""
    import dataclasses

    import torch

    from opencl_ray_tracer_tpu_torch.bench_util import (
        device_frame_time_us,
        device_step_time_us,
    )
    from opencl_ray_tracer_tpu_torch.entry import entry
    from opencl_ray_tracer_tpu_torch.kernels import fwd, fwd_tiled
    from opencl_ray_tracer_tpu_torch.kernels import soft as B
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
    from opencl_ray_tracer_tpu_torch.models.renderer import render_jit
    from opencl_ray_tracer_tpu_torch.ops.shading import pack_framebuffer_words
    from opencl_ray_tracer_tpu_torch.parallel.train import (
        adam,
        fixed_k_step,
        init_train_state,
        make_train_step,
        scene_leaves,
        step_taus,
        trainable_scene,
    )
    from opencl_ray_tracer_tpu_torch.runtime.graph import jit
    from opencl_ray_tracer_tpu_torch.utils import profiling as P
    from opencl_ray_tracer_tpu_torch.utils import tracing

    t_phase = time.perf_counter()
    launches = dict.fromkeys(GRAPH_KERNELS, 0)

    def counted(fn, fmt="packed"):
        tracing.reset()
        out = fn()
        torch.cuda.synchronize()
        for key in GRAPH_COUNTERS:
            n = tracing.counter("launch." + key)
            if key == "B1" and fmt != "packed":
                key = "B2"
            launches[key] += n
        return out

    w, h = 1920, 1080
    ortho = T.legacy_ortho_camera(device=dev)
    pin = T.pinhole_camera((w / 2.0, h / 2.0, 900.0), (w / 2.0, h / 2.0, -85.0),
                           fov_degrees=60.0, width=w, height=h, device=dev)
    headline = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
    hl_cfg = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                            framebuffer_dtype="packed")
    moves = [torch.tensor(v, dtype=torch.float32, device=dev) for v in
             ([0.0, 0.0, 0.0], [0.37, -0.21, 0.0], [-3.0, 2.5, 0.0],
              [11.25, 7.5, 0.0])]

    # ---- (a) hard frames, replayed with the camera moved ------------------
    fwd_e, (e_scene, e_cam) = entry()
    e_cfg = T.RenderConfig(width=640, height=480, shading="phong", shadows=True,
                           framebuffer_dtype="packed")
    cases = [("entry 640x480 scene1", e_scene, e_cam, e_cfg, fwd_e),
             ("headline 1080p packed", headline, ortho, hl_cfg, None),
             ("headline 1080p float", headline, ortho,
              hl_cfg.replace(framebuffer_dtype="float"), None),
             ("dynamic 1080p pinhole", headline, pin, hl_cfg, None)]
    compiled = {}
    for label, scene, cam, cfg, fn in cases:
        packed = scene.pack()
        # the eager path's final caps: the compiled frame bins at them
        bins = fwd_tiled.bin_for_config(packed, cam, cfg)
        caps = dict(cull_k=max(bins.k_tri, bins.k_sph),
                    shadow_cull_k=max(bins.k_sh_tri, bins.k_sh_sph, 8))
        cfg_k = cfg if fn is not None else cfg.replace(**caps)
        fn = fn or render_jit(cfg_k)
        compiled[label] = (fn, scene, cam, cfg_k)
        for i, d in enumerate(moves):
            c = dataclasses.replace(cam, o0=cam.o0 + d)
            got = counted(lambda: fn(scene, c), cfg.framebuffer_dtype).clone()
            want = fwd_tiled.render_tiled_packed(packed, c, cfg_k)
            same = torch.equal(got, want)
            if i in (0, len(moves) - 1):
                print(f"[graph] {label}: replay {i} (o0 moved by "
                      f"{d.tolist()}) vs eager render_tiled_packed at K "
                      f"{cfg_k.cull_k} / {cfg_k.shadow_cull_k}: identical {same}")
            _require(same, f"[graph] {label}: replay {i} is not the eager frame")
            _require(not bool(fwd_tiled.bin_fixed(packed, c, cfg_k).overflow),
                     f"[graph] {label}: the caps overflow")

    # the same frames below their need: the brute kernel's branch
    for label, scene, cam, cfg, _ in cases[:2] + cases[3:]:
        packed = scene.pack()
        cfg8 = cfg.replace(cull_k=8, shadow_cull_k=8)
        fn = render_jit(cfg8)

        def eager_brute(c):
            return pack_framebuffer_words(fwd.render_pallas_packed(
                packed, c, cfg8.replace(framebuffer_dtype="float")))

        for i, d in enumerate(moves[:2]):
            c = dataclasses.replace(cam, o0=cam.o0 + d)
            got = counted(lambda: fn(scene, c)).clone()
            flag_set = bool(fwd_tiled.bin_fixed(packed, c, cfg8).overflow)
            same = torch.equal(got, eager_brute(c))
            print(f"[graph] {label} at cull_k 8, replay {i}: overflow flag "
                  f"{flag_set}, the frame vs eager render_pallas_packed: "
                  f"identical {same}")
            _require(flag_set and same,
                     f"[graph] {label} at cull_k 8: the brute branch was not taken")

    # ---- (b) the soft fallback and train1080 ------------------------------
    soft_cfg = _soft_cfg(T, w, h, "phong", True)
    soft8 = soft_cfg.replace(cull_k=8, shadow_cull_k=8)
    taus = step_taus(soft_cfg, dev)

    def soft_fwd_bwd(scene, cam):
        s = trainable_scene(scene)
        leaves = scene_leaves(s)
        img = S._soft_tiled_core(s.pack(), cam, *taus, h, w, "phong", True,
                                 soft8.cull_k, soft8.shadow_cull_k)
        grads = torch.autograd.grad(_mean_sq(img), list(leaves.values()),
                                    allow_unused=True)
        return img.detach(), {k: torch.zeros_like(v) if g is None else g
                              for (k, v), g in zip(leaves.items(), grads)}

    soft_jit = jit(soft_fwd_bwd)
    _require(bool(S._bin_soft(headline.pack(), 0.5, ortho, height=h, width=w,
                              k=8, shadows=True, shadow_k=8).overflow),
             "[graph] the soft lists fit at cull_k 8")
    img, grads = counted(lambda: soft_jit(headline, ortho), "float")
    want_img = B._soft_render_core(headline.pack(), ortho, 1.0, 0.5, h, w, "phong",
                                   True, False)
    ierr = (img - want_img.detach()).abs().max().item()
    want_g = _leaf_grads(lambda s, c, cf: B._soft_render_core(
        s.pack(), c, 1.0, 0.5, h, w, "phong", True, False), headline, ortho,
        soft_cfg, _mean_sq)
    # two runs of B7, whose sums are atomic adds in no fixed order: a sum
    # near zero may read 0 in one run and a residue in the other (phase 12)
    gerr = _compare_grads("[graph] soft at cull_k 8 vs eager _soft_render_core",
                          grads, want_g, 1e-3, lost_floor=1e-3)
    print(f"[graph] soft frame at cull_k 8 (brute branch, 1080p phong + soft "
          f"shadows) vs eager _soft_render_core: image max err {ierr:.5f}/255 "
          f"(bar {FWD_BAR}), leaf gradients {gerr:.2e} normalised (bar 1e-3)")
    _require(ierr <= FWD_BAR, f"[graph] soft fallback image err {ierr}")

    target = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
    opt_e, opt_j = adam(1e-3), adam(1e-3)
    step_e = make_train_step(ortho, soft_cfg, opt_e)
    step_j = make_train_step(ortho, soft_cfg, opt_j, jit=True)
    state_e = init_train_state(headline, opt_e)
    state_j = init_train_state(headline, opt_j)
    lerr = serr = 0.0
    for i in range(5):
        if i:
            _copy_train_state(state_e, state_j)
        state_e, le = step_e(state_e, target)
        state_j, lj = counted(lambda: step_j(state_j, target), "float")
        le, lj = le.item(), lj.item()
        lerr = max(lerr, abs(lj - le) / abs(le))
        serr = max(serr, max(
            ((scene_leaves(state_j.scene)[k] - v).abs()
             / v.abs().clamp_min(1e-30)).max().item()
            for k, v in scene_leaves(state_e.scene).items()))
        print(f"[graph] train1080 step {i + 1}: jit loss {lj:.9g} vs eager "
              f"{le:.9g}")
    print(f"[graph] train1080, 5 jit=True steps vs the eager step from the same "
          f"state: largest relative difference of the loss {lerr:.2e}, of the "
          f"scene {serr:.2e} (bar 1e-6)")
    _require(lerr <= 1e-6 and serr <= 1e-6,
             f"[graph] the captured step is not the eager step: {lerr}, {serr}")
    print(f"[graph] launches of the compiled path (warm-up and capture of each "
          f"graph, B1/B2 at the warm-up only; a replay runs the graph's launches "
          f"without a wrapper call): "
          f"{launches}")
    _require(all(launches[k] >= 1 for k in GRAPH_KERNELS),
             f"[graph] the compiled path did not go through every kernel: {launches}")

    _branch_traces(16, "[graph]")

    # ---- (c) times ----------------------------------------------------------
    times = {}
    state_t = init_train_state(headline, adam(1e-3))
    step_t = make_train_step(ortho, soft_cfg, adam(1e-3))
    state_tj = init_train_state(headline, adam(1e-3))
    step_tj = make_train_step(ortho, soft_cfg, adam(1e-3), jit=True)
    rows = []
    for label, n in (("entry 640x480 scene1", 100), ("headline 1080p packed", 100),
                     ("dynamic 1080p pinhole", 50)):
        fn, scene, cam, cfg = compiled[label]
        rows.append((
            label,
            lambda s=scene, c=cam, f=cfg: fwd_tiled.render_tiled_packed(s.pack(), c, f),
            lambda fn=fn, s=scene, c=cam: fn(s, c),
            # the slope captures n frames of the frame's function in one graph
            lambda cc, s=scene, f=cfg: fwd_tiled.render_tiled_fixed(s, cc, f),
            cam, n, False))
    rows.append(("train1080 step", lambda: step_t(state_t, target),
                 lambda: step_tj(state_tj, target),
                 lambda cc: fixed_k_step(state_tj, target, cc, soft_cfg, taus),
                 ortho, 10, True))
    for label, eager_fn, replay_fn, slope_fn, cam, n, is_step in rows:
        e_ms = _time_ms(eager_fn, 20)
        r_ms = _time_ms(replay_fn, 50)
        e_prof = P.device_profile(eager_fn, 10)
        r_prof = P.device_profile(replay_fn, 10)
        slope = (device_step_time_us(slope_fn, cam, n_frames=n) if is_step else
                 device_frame_time_us(slope_fn, cam, n_frames=n))
        times[label] = dict(eager_ms=e_ms, replay_ms=r_ms, eager_prof=e_prof[:3],
                            replay_prof=r_prof[:3], slope_us=slope)
        print(f"[graph] [time] {label}: eager median {e_ms[0]:.4f} ms [{e_ms[1]:.4f}, "
              f"{e_ms[2]:.4f}], {e_prof[0]:.1f} device kernels a call, busy "
              f"{e_prof[1]:.4f} ({e_prof[2]:.4f} ms of device work); replay "
              f"median {r_ms[0]:.4f} ms [{r_ms[1]:.4f}, {r_ms[2]:.4f}], "
              f"{r_prof[0]:.1f} device kernels a call, busy {r_prof[1]:.4f} "
              f"({r_prof[2]:.4f} ms); the JAX bench's slope over {n} "
              f"{'steps' if is_step else 'frames'} in one graph {slope:.2f} us; "
              f"{smi}")
    print(f"[graph] phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return launches, times


# ---------------------------------------------------------------------------
# The JAX package's last compiled forms: the mesh step with its all-reduce in
# the graph, the compiled sharded frame, the compiled fit, the xla forms
# ---------------------------------------------------------------------------

def compiled_forms_phase(T, dev, smi):
    """Phase 17: the JAX package's last compiled forms on one card. Its
    main path runs with every count set to 0 just before each call and read
    just after. (i) C1: the 40-sphere pile (256x128, lambert, the default
    caps) through `render_soft_pallas`: the overflow flag set, B6/B7
    launched and B4/B5 not, the image within 0.05/255 of eager
    `_soft_render_core` and the leaf gradients within 1e-3 normalised of the
    brute backward's; train1080 through `render_soft_pallas`: B4/B5
    launched and B6/B7 not. (ii) the compiled mesh step
    (`make_train_step(..., mesh=, jit=True)`) over a one-rank NCCL group,
    on `make_mesh(1)` and on `make_mesh_2d(1, 1)` (two one-rank
    communicators in one graph): 5 train1080 steps in lockstep with the
    eager mesh step (one state taken to both sides before each step, for
    B5's atomics), loss and every leaf within 1e-6 relative; one replay
    traced (its device operations, the NCCL kernel among them) and its
    per-call median beside the eager mesh step's. (iii) the compiled
    sharded frame (`render_sharded_jit` on `make_mesh(1)`): the headline
    1080p frame, packed and float, replayed with the camera moved, equal to
    the eager tiled frame word for word (bit for bit); at cull_k 8 the flag
    set and the frame the eager brute frame's words; the train1080 soft
    frame and the `xla` frame equal to their eager blocks. (iv) the
    compiled fit: `fit_scene` (scene 1 at 640x480, 20 steps, on the
    group's mesh) through the compiled step, which must lower the loss; the
    same compiled step in lockstep with the eager step for 20 steps (1e-6
    relative); then 20 compiled steps straight, checkpointed at step 10,
    against a state whose graph is already captured, resumed from that
    checkpoint in place and stepped 10 more times (1e-6 relative). (v) the
    `xla` forms: `render_xla_jit` at 1080p phong + shadows, int and float,
    equal to the eager `render_xla` word for word and bit for bit; the
    `jit=True` step on backend `xla` at 256x128 in lockstep with the eager
    `xla` step for 3 steps (1e-6 relative); replay and eager per-call
    medians. Then each compiled case of (ii)-(iv), built again in a process
    of its own, has one replay traced: it holds the kernels of the branch
    taken and none of the other branch's (`_branch_traces`). Returns the
    launches of its main path per kernel."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist

    from opencl_ray_tracer_tpu_torch.diff import render_soft
    from opencl_ray_tracer_tpu_torch.kernels import fwd, fwd_tiled
    from opencl_ray_tracer_tpu_torch.kernels import soft as B
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
    from opencl_ray_tracer_tpu_torch.kernels.soft import render_soft_pallas
    from opencl_ray_tracer_tpu_torch.models.inverse import (
        SPHERE_PARAMS,
        fit_scene,
        param_filter_from_names,
        perturb_scene,
    )
    from opencl_ray_tracer_tpu_torch.models.xla_backend import (
        render_xla,
        render_xla_jit,
    )
    from opencl_ray_tracer_tpu_torch.ops.shading import pack_framebuffer_words
    from opencl_ray_tracer_tpu_torch.parallel import (
        adam,
        distributed,
        init_train_state,
        make_mesh,
        make_mesh_2d,
        make_train_step,
        render_sharded,
        render_sharded_jit,
        replicate,
        scene_leaves,
        shard_rows,
    )
    from opencl_ray_tracer_tpu_torch.parallel.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from opencl_ray_tracer_tpu_torch.utils import profiling as P
    from opencl_ray_tracer_tpu_torch.utils import tracing

    t_phase = time.perf_counter()
    launches = dict.fromkeys(GRAPH_KERNELS, 0)
    times = {}

    def counted(fn, fmt="float"):
        """fn() with every count set to 0 just before and read just after;
        returns (fn's result, this call's launches per kernel)."""
        tracing.reset()
        out = fn()
        torch.cuda.synchronize()
        got = {}
        for key in GRAPH_COUNTERS:
            n = tracing.counter("launch." + key)
            if key == "B1" and fmt != "packed":
                key = "B2"
            got[key] = n
            launches[key] += got[key]
        return out, got

    def rel_err(a, b):
        return ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()

    def scene_err(a, b, norm):
        """(largest difference of two scenes, its leaf): relative to each
        element, or with `norm` to the leaf's largest magnitude."""
        worst = (0.0, None)
        for k, v in scene_leaves(b.scene).items():
            d = scene_leaves(a.scene)[k] - v
            e = ((d.abs().max() / v.abs().max().clamp_min(1e-30)).item() if norm
                 else rel_err(scene_leaves(a.scene)[k], v))
            worst = max(worst, (e, k), key=lambda t: t[0])
        return worst

    def lockstep(step_a, state_a, step_b, state_b, target, n, label, norm=False):
        """n steps of two steps, state_a taken to state_b before each (for
        B5's atomics): the largest relative difference of the loss and of
        the scene (each element's, or with `norm` normalised by each leaf's
        largest), and state_b's losses."""
        lerr, serr, worst, losses = 0.0, 0.0, None, []
        for i in range(n):
            if i:
                _copy_train_state(state_a, state_b)
            state_a, la = step_a(state_a, target)
            (state_b, lb), _ = counted(lambda: step_b(state_b, target))
            la, lb = la.item(), lb.item()
            losses.append(lb)
            lerr = max(lerr, abs(lb - la) / abs(la))
            e, k = scene_err(state_b, state_a, norm)
            if e > serr:
                serr, worst = e, k
        print(f"[compiled] {label}, {n} steps in lockstep: largest relative "
              f"difference of the loss {lerr:.2e}, of the scene {serr:.2e} "
              f"({'normalised by each leaf' if norm else 'each element'}, at "
              f"{worst}; bar 1e-6); losses {losses[0]:.9g} -> {losses[-1]:.9g}")
        _require(lerr <= 1e-6 and serr <= 1e-6,
                 f"[compiled] {label}: {lerr}, {serr} over 1e-6")
        return state_a, state_b, losses

    w, h = 1920, 1080
    ortho = T.legacy_ortho_camera(device=dev)
    headline = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
    soft_cfg = _soft_cfg(T, w, h, "phong", True)

    # ---- (i) C1: the brute frame where a list overflows its cap -----------
    pile = T.random_scene(40, 0, seed=9, bounds=(60.0, 40.0), device=dev)
    pile_cfg = _soft_cfg(T, SOFT_W, SOFT_H, "lambert", False)
    flag = S._bin_soft(pile.pack(), 0.5, ortho, height=SOFT_H, width=SOFT_W,
                       k=pile_cfg.cull_k, shadows=False,
                       shadow_k=pile_cfg.shadow_cull_k).overflow
    _require(bool(flag), "[compiled] the pile fits its lists at the default caps")
    got_g, used = counted(lambda: _leaf_grads(render_soft_pallas, pile, ortho,
                                              pile_cfg, _mean_sq))
    with torch.no_grad():
        img = render_soft_pallas(pile, ortho, pile_cfg)
        want = B._soft_render_core(pile.pack(), ortho, 1.0, 0.5, SOFT_H, SOFT_W,
                                   "lambert", False, False)
    ierr = (img - want).abs().max().item()
    want_g = _leaf_grads(lambda s, c, cf: B._soft_render_core(
        s.pack(), c, 1.0, 0.5, SOFT_H, SOFT_W, "lambert", False, False), pile,
        ortho, pile_cfg, _mean_sq)
    # two runs of B7, whose sums are atomic adds in no fixed order; the pile
    # has no triangles, so their leaves are empty
    keep = [k for k, v in want_g.items() if v.numel()]
    gerr = _compare_grads("[compiled] C1 pile", {k: got_g[k] for k in keep},
                          {k: want_g[k] for k in keep}, 1e-3, lost_floor=1e-3)
    print(f"[compiled] C1: the 40-sphere pile at cull_k {pile_cfg.cull_k} / "
          f"{pile_cfg.shadow_cull_k}: overflow flag {bool(flag)}, launches {used}; "
          f"image vs eager _soft_render_core max err {ierr:.5f}/255 (bar "
          f"{FWD_BAR}), leaf gradients {gerr:.2e} normalised (bar 1e-3)")
    _require(used["B6"] >= 1 and used["B7"] >= 1 and used["B4"] == 0
             and used["B5"] == 0, f"[compiled] C1 pile launches {used}")
    _require(ierr <= FWD_BAR, f"[compiled] C1 pile image err {ierr}")
    _, used = counted(lambda: _leaf_grads(render_soft_pallas, headline, ortho,
                                          soft_cfg, _mean_sq))
    print(f"[compiled] C1: train1080 at cull_k {soft_cfg.cull_k} / "
          f"{soft_cfg.shadow_cull_k} through render_soft_pallas: launches {used}")
    _require(used["B4"] >= 1 and used["B5"] >= 1 and used["B6"] == 0
             and used["B7"] == 0, f"[compiled] C1 train1080 launches {used}")

    # ---- (ii) the compiled mesh step over a one-rank NCCL group -----------
    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0)
    try:
        nccl = ".".join(map(str, torch.cuda.nccl.version()))
        print(f"[compiled] process group: world size {dist.get_world_size()}, "
              f"backend {dist.get_backend()}, NCCL {nccl}, "
              f"NCCL_GRAPH_MIXING_SUPPORT="
              f"{os.environ.get('NCCL_GRAPH_MIXING_SUPPORT', 'unset (default 1)')}")
        target = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
        for label, mesh in (("make_mesh(1)", make_mesh(1)),
                            ("make_mesh_2d(1, 1)", make_mesh_2d(1, 1))):
            backends = [dist.get_backend(g) for g in mesh.reduce_groups]
            _require(backends and all(b == "nccl" for b in backends),
                     f"[compiled] {label} groups {backends}")
            opt_e, opt_j = adam(1e-3), adam(1e-3)
            step_e = make_train_step(ortho, soft_cfg, opt_e, mesh=mesh)
            step_j = make_train_step(ortho, soft_cfg, opt_j, mesh=mesh, jit=True)
            state_e = init_train_state(replicate(headline, mesh), opt_e)
            state_j = init_train_state(replicate(headline, mesh), opt_j)
            tgt = shard_rows(target, mesh)
            state_e, state_j, _ = lockstep(
                step_e, state_e, step_j, state_j, tgt, 5,
                f"train1080 mesh step on {label} ({len(backends)} NCCL "
                f"communicators), jit=True vs eager")
            names = P.trace_ops(lambda: step_j(state_j, tgt))
            n_ops = len(names)
            nccl_names = sorted({n for n in names if "nccl" in n.lower()})
            has_nccl = bool(nccl_names)
            e_ms = _time_ms(lambda: step_e(state_e, tgt), 20)
            r_ms = _time_ms(lambda: step_j(state_j, tgt), 50)
            times[label] = (e_ms, r_ms)
            # NCCL runs no kernel for an in-place all-reduce on a one-rank
            # communicator, so a one-card replay shows none; the capture of
            # the collective itself raises where NCCL refuses it
            # (scripts/torch_mesh_cards.py traces a replay over 4 cards)
            print(f"[compiled] [time] train1080 mesh step on {label}: one replay "
                  f"runs {n_ops} device operations (profiler), an NCCL kernel "
                  f"among them: {has_nccl} {nccl_names} (one rank: NCCL launches "
                  f"none for an in-place all-reduce); replay median "
                  f"{r_ms[0]:.4f} ms [{r_ms[1]:.4f}, {r_ms[2]:.4f}] over 50, eager "
                  f"mesh step {e_ms[0]:.4f} ms [{e_ms[1]:.4f}, {e_ms[2]:.4f}] over "
                  f"20 (eager / replay {e_ms[0] / r_ms[0]:.2f}x); {smi}")
            # an eager all-reduce on the communicators the graph holds, then a
            # replay: captured and eager collectives mix on one communicator
            probe = mesh.all_reduce(torch.ones(4, device=dev))
            (_, lj), _ = counted(lambda: step_j(state_j, tgt))
            _require(bool(torch.isfinite(lj)) and probe.sum().item() == 4.0,
                     f"[compiled] {label}: an eager all-reduce beside the replays")

        # ---- (iii) the compiled sharded frame --------------------------------
        mesh = make_mesh(1)
        hl_cfg = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                                framebuffer_dtype="packed")
        moves = [torch.tensor(v, dtype=torch.float32, device=dev)
                 for v in ([0.0, 0.0, 0.0], [0.37, -0.21, 0.0], [-3.0, 2.5, 0.0])]
        packed = headline.pack()
        for cfg in (hl_cfg, hl_cfg.replace(framebuffer_dtype="float")):
            fmt = cfg.framebuffer_dtype
            fn = render_sharded_jit(cfg, mesh)
            for i, d in enumerate(moves):
                c = dataclasses.replace(ortho, o0=ortho.o0 + d)
                got, _ = counted(lambda: fn(headline, c).clone(), fmt)
                _require(not bool(fwd_tiled.bin_fixed(packed, c, cfg).overflow),
                         f"[compiled] headline {fmt}: the caps overflow")
                want = fwd_tiled.render_tiled_packed(packed, c, cfg)
                _require(torch.equal(got, want), f"[compiled] sharded headline "
                         f"{fmt}, replay {i}: not the eager frame")
            print(f"[compiled] render_sharded_jit on make_mesh(1), the headline "
                  f"1080p {fmt} frame, {len(moves)} replays with the camera moved: "
                  f"identical to eager render_tiled_packed at K {cfg.cull_k} / "
                  f"{cfg.shadow_cull_k}")
        cfg8 = hl_cfg.replace(cull_k=8, shadow_cull_k=8)
        fn8 = render_sharded_jit(cfg8, mesh)
        for i, d in enumerate(moves[:2]):
            c = dataclasses.replace(ortho, o0=ortho.o0 + d)
            got, used = counted(lambda: fn8(headline, c).clone(), "packed")
            flag8 = bool(fwd_tiled.bin_fixed(packed, c, cfg8).overflow)
            want = pack_framebuffer_words(fwd.render_pallas_packed(
                packed, c, cfg8.replace(framebuffer_dtype="float")))
            same = torch.equal(got, want)
            print(f"[compiled] render_sharded_jit at cull_k 8, call {i}: overflow "
                  f"flag {flag8}, the frame vs eager render_pallas_packed: "
                  f"identical {same}; launches {used}")
            _require(flag8 and same, "[compiled] the sharded frame at cull_k 8 is "
                     "not the brute frame")
        for label, cfg in (("train1080 soft", soft_cfg),
                           ("xla phong+shadows float",
                            hl_cfg.replace(framebuffer_dtype="float", backend="xla"))):
            fn = render_sharded_jit(cfg, mesh)
            got, _ = counted(lambda: fn(headline, ortho).clone())
            with torch.no_grad():
                want = render_sharded(headline, ortho, cfg, mesh=mesh)
            _require(torch.equal(got, want), f"[compiled] sharded {label}: not the "
                     "eager block")
            print(f"[compiled] render_sharded_jit {label} 1080p on make_mesh(1): "
                  f"identical to the eager render_sharded")

        # ---- (iv) the compiled fit --------------------------------------------
        fw, fh = 640, 480
        fit_cfg = T.RenderConfig(width=fw, height=fh, shading="lambert", soft=True,
                                 framebuffer_dtype="float", tau_depth=1.0,
                                 tau_edge=0.5)
        true_scene = T.create_scene(1, seed=0, device=dev)
        with torch.no_grad():
            fit_target = render_soft(true_scene, ortho, fit_cfg)
        init = perturb_scene(true_scene, seed=1)
        (fitted, fit_losses), used = counted(lambda: fit_scene(
            init, fit_target, camera=ortho, config=fit_cfg, steps=20,
            learning_rate=0.5, trainable=SPHERE_PARAMS, log_every=1))
        print(f"[compiled] fit_scene 640x480 scene 1, 20 compiled steps on the "
              f"group's mesh: loss {fit_losses[0]:.6f} -> {fit_losses[-1]:.6f}; "
              f"launches {used}")
        _require(len(fit_losses) == 20 and fit_losses[-1] < fit_losses[0],
                 f"[compiled] fit_scene losses {fit_losses}")
        fmesh = make_mesh()
        fltr = param_filter_from_names(SPHERE_PARAMS)

        def fit_step(jit):
            opt = adam(0.5)
            step = make_train_step(ortho, fit_cfg, opt, mesh=fmesh,
                                   param_filter=fltr, jit=jit)
            return step, init_train_state(replicate(init, fmesh), opt)

        (step_e, state_e), (step_j, state_j) = fit_step(False), fit_step(True)
        tgt = shard_rows(fit_target, fmesh)
        # Adam at 0.5 moves a sphere parameter near zero by a step that B5's
        # atomic order changes in its last bits: each leaf's error is read
        # against its largest magnitude (an element's own read 3.4e-6)
        _, _, lock_losses = lockstep(step_e, state_e, step_j, state_j, tgt, 20,
                                     "fit 640x480, jit=True vs eager", norm=True)
        drift = max(abs(a - b) / abs(b) for a, b in zip(fit_losses, lock_losses))
        print(f"[compiled] fit_scene's losses vs the lockstep compiled run's: "
              f"largest relative difference {drift:.2e} (two runs, not lockstep)")
        step_a, state_a = fit_step(True)
        step_b, state_b = fit_step(True)
        with tempfile.TemporaryDirectory() as ck:
            straight = []
            for i in range(20):
                (state_a, la), _ = counted(lambda: step_a(state_a, tgt))
                straight.append(la.item())
                if i == 9:
                    path = save_checkpoint(ck, state_a, mesh=fmesh)
            step_b(state_b, tgt)  # captures state_b's graph
            state_b = load_checkpoint(path, state_b)
            resumed = []
            for _ in range(10):
                (state_b, lb), _ = counted(lambda: step_b(state_b, tgt))
                resumed.append(lb.item())
        lerr = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight[10:]))
        serr, worst = scene_err(state_b, state_a, True)
        print(f"[compiled] resume: 20 compiled steps straight vs a captured state "
              f"resumed in place from the step-10 checkpoint and stepped 10 times: "
              f"largest relative difference of the loss {lerr:.2e}, of the final "
              f"scene {serr:.2e} (normalised by each leaf, at {worst}; bar 1e-6)")
        _require(lerr <= 1e-6 and serr <= 1e-6, f"[compiled] resume: {lerr}, {serr}")
    finally:
        dist.destroy_process_group()

    # ---- (v) the xla forms ----------------------------------------------------
    for as_int in (True, False):
        kw = dict(height=h, width=w, shading="phong", shadows=True, as_int=as_int)
        xcfg = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                              framebuffer_dtype="int" if as_int else "float")
        got, _ = counted(lambda: render_xla_jit(headline, ortho, **kw).clone())
        want = render_xla(headline, ortho, xcfg)
        _require(torch.equal(got, want), f"[compiled] render_xla_jit as_int={as_int}"
                 ": not the eager frame")
        e_ms = _time_ms(lambda: render_xla(headline, ortho, xcfg), 20)
        r_ms = _time_ms(lambda: render_xla_jit(headline, ortho, **kw), 50)
        times[f"xla {'int' if as_int else 'float'}"] = (e_ms, r_ms)
        print(f"[compiled] [time] render_xla_jit 1080p phong+shadows "
              f"{'int' if as_int else 'float'}: identical to eager render_xla; "
              f"replay median {r_ms[0]:.4f} ms [{r_ms[1]:.4f}, {r_ms[2]:.4f}] over "
              f"50, eager {e_ms[0]:.4f} ms [{e_ms[1]:.4f}, {e_ms[2]:.4f}] over 20; "
              f"{smi}")
    small = T.random_scene(5, 3, seed=4, bounds=(250.0, 120.0), device=dev)
    xla_cfg = _soft_cfg(T, SOFT_W, SOFT_H, "phong", True).replace(backend="xla")
    xtarget = torch.zeros((SOFT_H, SOFT_W, 4), dtype=torch.float32, device=dev)
    opt_e, opt_j = adam(1e-2), adam(1e-2)
    step_e = make_train_step(ortho, xla_cfg, opt_e)
    step_j = make_train_step(ortho, xla_cfg, opt_j, jit=True)
    state_e, state_j, _ = lockstep(step_e, init_train_state(small, opt_e), step_j,
                                   init_train_state(small, opt_j), xtarget, 3,
                                   "xla train step 256x128 phong + soft shadows, "
                                   "jit=True vs eager")
    e_ms = _time_ms(lambda: step_e(state_e, xtarget), 20)
    r_ms = _time_ms(lambda: step_j(state_j, xtarget), 50)
    times["xla step"] = (e_ms, r_ms)
    print(f"[compiled] [time] xla train step 256x128: replay median {r_ms[0]:.4f} "
          f"ms [{r_ms[1]:.4f}, {r_ms[2]:.4f}] over 50, eager {e_ms[0]:.4f} ms "
          f"[{e_ms[1]:.4f}, {e_ms[2]:.4f}] over 20; {smi}")

    _branch_traces(17, "[compiled]")
    print(f"[compiled] launches of phase 17's path (warm-up and capture of each "
          f"graph counted, B1/B2 at the warm-up only; a replay runs the graph's launches without a wrapper "
          f"call): {launches}")
    _require(all(launches[k] >= 1 for k in GRAPH_KERNELS),
             f"[compiled] phase 17's path did not go through every kernel: {launches}")
    print(f"[compiled] phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# The stored-finals regime of the tiled soft pair (B4 writes a finals block,
# B5 reads it in place of its recompute pass)
# ---------------------------------------------------------------------------

def finals_phase(T, dev, smi):
    """Phase 18 (see the module's docstring). Returns the launches of B4 and
    B5 on its main paths, and per path (eager, bench, compiled) the B4 and
    B5 launches made with a finals block."""
    import numpy as np
    import torch

    from opencl_ray_tracer_tpu_torch import bench as BN
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
    from opencl_ray_tracer_tpu_torch.parallel.train import (
        adam,
        init_train_state,
        make_train_step,
        scene_leaves,
        trainable_scene,
    )
    from opencl_ray_tracer_tpu_torch.utils import tracing

    t_phase = time.perf_counter()
    w, h = 1920, 1080
    ortho = T.legacy_ortho_camera(device=dev)
    headline = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
    fifty = T.random_scene(50, 4, seed=1, bounds=(1910.0, 1070.0), device=dev)
    stress = T.random_scene(100, 100, seed=0, bounds=(1910.0, 1070.0), device=dev)
    soft = _soft_cfg(T, w, h, "phong", True)
    stress_cfg = soft.replace(cull_k=96, shadow_cull_k=136)
    launches = {"B4": 0, "B5": 0}
    paths = {}

    def counted(path, fn):
        """fn() with the counts set to 0 just before and read just after."""
        tracing.reset()
        out = fn()
        torch.cuda.synchronize()
        launches["B4"] += tracing.counter("launch.B4")
        launches["B5"] += tracing.counter("launch.B5")
        got = (tracing.counter("launch.B4_finals"), tracing.counter("launch.B5_finals"))
        old = paths.get(path, (0, 0))
        paths[path] = (old[0] + got[0], old[1] + got[1])
        return out

    def regime(threshold):
        S._FINALS_MIN_SLOTS = threshold

    threshold = S._FINALS_MIN_SLOTS

    # ---- the main paths that take the stored regime, counted ---------------
    s = trainable_scene(stress)
    counted("eager", lambda: _mean_sq(S.render_soft_tiled(s, ortho, stress_cfg)).backward())
    _require(bool(torch.isfinite(s.sphere_origin.grad).all()
                  and (s.sphere_origin.grad != 0).any()),
             "[finals] the eager stress step gave no finite gradient")
    for scene, cfg in ((fifty, soft), (stress, stress_cfg)):
        step, bins = BN.bench_fwd_bwd_soft(scene, cfg, ortho)
        _require(S._use_stored_finals(bins, 1, True),
                 f"[finals] the bench's {S._finals_slots(bins, 1, True)}-slot step "
                 "does not take the stored regime")
        counted("bench", step)
    target = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
    for label, cfg, brute in (("K 96 / 136", stress_cfg, False),
                              ("K 32 / 64", soft, True)):
        bins = S._bin_soft(stress.pack(), cfg.tau_edge, ortho, height=h, width=w,
                           k=cfg.cull_k, shadows=True, shadow_k=cfg.shadow_cull_k)
        _require(bool(bins.overflow) == brute and S._use_stored_finals(bins, 1, True),
                 f"[finals] stress at {label}: overflow {bool(bins.overflow)}, "
                 f"{S._finals_slots(bins, 1, True)} slots")
        opt_e, opt_j = adam(1e-3), adam(1e-3)
        step_e = make_train_step(ortho, cfg, opt_e)
        step_j = make_train_step(ortho, cfg, opt_j, jit=True)
        state_e = init_train_state(stress, opt_e)
        state_j = init_train_state(stress, opt_j)
        # Adam moves a parameter whose gradient sums near zero by a step that
        # B5's atomic order can change in its last bits, and at 1,300
        # primitives some do: each leaf's error is read against its largest
        # magnitude, as phase 17 reads the fit's (an element's own relative
        # error read up to 1.07e-6 here)
        lerr = serr = eerr = 0.0
        for i in range(2):  # the capture, then a replay
            if i:
                _copy_train_state(state_e, state_j)
            state_e, le = step_e(state_e, target)
            state_j, lj = counted("compiled", lambda: step_j(state_j, target))
            le, lj = le.item(), lj.item()
            lerr = max(lerr, abs(lj - le) / abs(le))
            for k, v in scene_leaves(state_e.scene).items():
                d = (scene_leaves(state_j.scene)[k] - v).abs()
                serr = max(serr, (d.max() / v.abs().max().clamp_min(1e-30)).item())
                eerr = max(eerr, (d / v.abs().clamp_min(1e-30)).max().item())
        print(f"[finals] the compiled stress step at {label} ({'brute' if brute else 'tiled'} "
              f"branch, {S._finals_slots(bins, 1, True)} slots), 2 steps in lockstep "
              f"with the eager step: largest relative difference of the loss "
              f"{lerr:.2e}, of the scene {serr:.2e} normalised by each leaf (bar "
              f"1e-6; {eerr:.2e} relative to each element)")
        _require(lerr <= 1e-6 and serr <= 1e-6,
                 f"[finals] compiled stress step at {label}: {lerr}, {serr}")
    print(f"[finals] launches with a finals block (B4, B5) by path: {paths}; all "
          f"B4 / B5 launches of the phase's paths: {launches}")
    _require(all(a >= 1 and b >= 1 for a, b in paths.values()) and len(paths) == 3,
             f"[finals] a path did not launch B4 and B5 with a finals block: {paths}")

    # ---- B4's block against the plain block; B5 reading it -----------------
    try:
        for label, scene, cfg in (("train1080", headline, soft),
                                  ("stress 1080p", stress, stress_cfg)):
            regime(0)
            ops = _soft_operands(scene, ortho, cfg)
            kc = ops[4]
            block = S.finals_block(kc, dev).fill_(float("nan"))
            S.soft_tiled_fwd(*ops[:4], cfg=kc, finals=block)
            with torch.no_grad():
                img, want = S._soft_tiled_plain(*ops[:4], cfg=kc, want_finals=True)
            names = [n for n, _ in S.finals_layout(kc)]
            written = ~want.isnan()
            _require(torch.equal(block[:, :, :13].isnan(), want[:, :, :13].isnan()),
                     f"[finals] {label}: B4 wrote other slots than the plain block")
            lv_differ = int((block[:, :, 13:].isnan() != want[:, :, 13:].isnan()).sum())
            _require(lv_differ <= 1e-3 * int(written[:, :, 0].sum()),
                     f"[finals] {label}: {lv_differ} logvis slots differ in coverage")
            worst = (0.0, None)
            worst_vis, vis_tight = 0.0, 1.0
            for i, name in enumerate(names):
                mask = written[:, :, i] & ~block[:, :, i].isnan()
                a, b = block[:, :, i][mask], want[:, :, i][mask]
                if name == "bacc" or name.startswith("logvis"):
                    a, b = a.exp(), b.exp()
                _require(bool(torch.isfinite(a).all()), f"[finals] {label} {name}: non-finite")
                err = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                if name.startswith("logvis"):
                    worst_vis = max(worst_vis, err)
                    vis_tight = min(vis_tight, ((a - b).abs() <= 1e-4).float().mean().item())
                else:
                    worst = max(worst, (err, name), key=lambda t: t[0])
            print(f"[finals] {label}: B4's block vs the plain block, {len(names)} rows "
                  f"on {int(written[:, :, 0].sum())} written pixel slots: largest "
                  f"normalised error {worst[0]:.2e} (row {worst[1]}, bacc through exp; "
                  f"bar 1e-4), the visibilities exp(logvis) {worst_vis:.2e} (bar "
                  f"5e-3), {vis_tight:.6f} of them within 1e-4 (bar 0.999); logvis "
                  f"slots whose coverage differs at the float32 edge {lv_differ}")
            _require(worst[0] <= 1e-4 and worst_vis <= 5e-3 and vis_tight >= 0.999,
                     f"[finals] {label}: block row error {worst}, {worst_vis}, {vis_tight}")
            del img, want
            g = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
            frame = S.soft_tiled_fwd(*ops[:4], cfg=kc)
            g[..., :3] = 2.0 * frame[..., :3] / (h * w * 3)
            g_dense = torch.full_like(g, 1e-6)
            fresh = S.finals_block(kc, dev)
            S.soft_tiled_fwd(*ops[:4], cfg=kc, finals=fresh)
            for cname, gc in (("the loss's", g), ("a dense", g_dense)):
                stored = S.soft_tiled_bwd(*ops[:4], gc, cfg=kc, finals=fresh)
                from_nan = S.soft_tiled_bwd(*ops[:4], gc, cfg=kc, finals=block)
                recompute = S.soft_tiled_bwd(*ops[:4], gc, cfg=kc)
                e_rec = e_nan = 0.0
                for name, a, b, c in zip(_SOFT_OPERANDS, stored, from_nan, recompute):
                    _require(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
                             f"[finals] {label} {name}: non-finite gradient")
                    scale = c.abs().max().clamp_min(1e-30)
                    e_rec = max(e_rec, ((a - c).abs().max() / scale).item())
                    e_nan = max(e_nan, ((b - a).abs().max() / scale).item())
                print(f"[finals] {label}, {cname} cotangent: B5 reading the block vs "
                      f"B5 recomputing {e_rec:.2e} (bar 1e-5), a NaN-prefilled block "
                      f"vs an unfilled one {e_nan:.2e} (bar 1e-6), normalised")
                _require(e_rec <= 1e-5 and e_nan <= 1e-6,
                         f"[finals] {label} {cname}: {e_rec}, {e_nan}")
            zeros = S.soft_tiled_bwd(*ops[:4], torch.zeros_like(g), cfg=kc, finals=block)
            _require(all(bool((z == 0).all()) for z in zeros),
                     f"[finals] {label}: an all-zero cotangent gave non-zero gradients")
            del ops, block, fresh, g, g_dense, frame
            torch.cuda.empty_cache()

        # ---- phase 7's cases and probes, the regime forced -------------------
        worst, worst_r, n = 0.0, 0.0, 0
        for scene_name in ("test", "scene1"):
            scene = (T.random_scene(5, 3, seed=4, bounds=(250.0, 120.0), device=dev)
                     if scene_name == "test" else T.create_scene1(device=dev))
            for cam_kind in ("ortho", "pinhole"):
                cam = (ortho if cam_kind == "ortho"
                       else T.pinhole_camera(**SOFT_PINHOLE, device=dev))
                atol = 1e-3 if cam_kind == "ortho" else 2e-3
                for shading, shadows in SOFT_MODES:
                    cfg = _soft_cfg(T, SOFT_W, SOFT_H, shading, shadows)
                    label = f"[finals] {scene_name} {cam_kind} {shading} shadows={shadows}"
                    regime(0)
                    gk = _leaf_grads(S.render_soft_tiled, scene, cam, cfg, _mean_sq)
                    gt = _leaf_grads(_twin_render, scene, cam, cfg, _mean_sq)
                    regime(1 << 30)
                    gr = _leaf_grads(S.render_soft_tiled, scene, cam, cfg, _mean_sq)
                    worst = max(worst, _compare_grads(label, gk, gt, atol))
                    # two runs of B5 through the gather's autograd: the atomics'
                    # order shows in a leaf summed near zero (phase 12), so
                    # phase 7's bar; the operands above are held within 1e-5
                    worst_r = max(worst_r, _compare_grads(
                        label + " vs recompute", gk, gr, atol, lost_floor=1e-3))
                    n += 1
        print(f"[finals] {n} cases of phase 7 in the stored regime: leaf gradients "
              f"vs the twin's, normalised max err {worst:.2e}, vs the recompute "
              f"regime's {worst_r:.2e} (bars 1e-3, pinhole 2e-3)")
        regime(0)
        scene = T.create_scene1(device=dev)
        cfg = _soft_cfg(T, SOFT_W, SOFT_H, "phong", True)
        rng = np.random.default_rng(11)
        err = 0.0
        for pi in range(16):
            yy, xx = int(rng.integers(20, SOFT_H - 20)), int(rng.integers(40, SOFT_W - 40))
            rows = [_leaf_grads(fn, scene, ortho, cfg,
                                lambda im, yy=yy, xx=xx, c=pi % 3: im[yy, xx, c] / 255.0)
                    for fn in (S.render_soft_tiled, _twin_render)]
            for k in rows[0]:
                err = max(err, (rows[0][k] - rows[1][k]).abs().max().item())
        print(f"[finals] 16 pixel-gradient rows, scene 1 phong+shadows 256x128, stored "
              f"regime: kernel vs twin max-abs {err:.3e} (bar 1e-4)")
        _require(err <= 1e-4, f"[finals] pixel-gradient rows {err}")
    finally:
        regime(threshold)
    print(f"[finals] phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return launches, paths


def _orbit_pinhole(T, dev, angle_deg, w=1920, h=1080):
    """A pinhole camera of the flythrough's orbit about the headline scene
    (radius 900, 120 below the centre, fov 60)."""
    import math

    a = math.radians(angle_deg)
    cx, cy, cz = 955.0, 535.0, -60.0
    return T.pinhole_camera((cx + 900.0 * math.sin(a), cy - 120.0,
                             cz + 900.0 * math.cos(a)), (cx, cy, cz),
                            fov_degrees=60.0, width=w, height=h, device=dev)


def bin_phase(T, dev, smi):
    """Phase 19 (see the module's docstring). Returns the `kernels` rows of
    the binning wrapper (bin_prep_kernel + bin_tiles_kernel), the gather
    kernel and the soft binning, each with the name of its launch counter
    under "counter", and the record of B1's cull (`_b1_cull_check`)."""
    import torch

    from opencl_ray_tracer_tpu_torch.bench_util import device_ms
    from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
    from opencl_ray_tracer_tpu_torch.utils import profiling as P
    from opencl_ray_tracer_tpu_torch.utils import tracing

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    w, h = 1920, 1080
    cfg = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                         framebuffer_dtype="packed")
    exact = ("t_idx", "t_valid", "s_idx", "s_valid", "counts", "overflow")
    scene_d = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
    scene_c = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=cpu)
    cams = [("ortho", T.legacy_ortho_camera(device=dev),
             T.legacy_ortho_camera(device=cpu))]
    cams += [(f"pinhole {a}", _orbit_pinhole(T, dev, a), _orbit_pinhole(T, cpu, a))
             for a in (0, 90, 150, 270)]
    kw = dict(height=h, width=w, k=cfg.cull_k, shadows=True,
              shadow_k=cfg.shadow_cull_k)
    gkw = dict(height=h, width=w, shading="phong", shadows=True, out_format="packed")
    tracing.reset()
    worst_coef, bin_err, gather_err = 0.0, 0.0, 0.0
    for label, cam_d, cam_c in cams:
        pd, pc = scene_d.pack(), scene_c.pack()
        got = fwd_tiled.bin_scene(pd, camera=cam_d, **kw)
        want = fwd_tiled.bin_scene(pc, camera=cam_c, **kw)
        for f in exact:
            _require(torch.equal(getattr(got, f).cpu(), getattr(want, f)),
                     f"[bins] {label}: {f} differs from the twin's")
        keep = [0, 1, 2, 6, 7]  # tri_attr_t's copied columns (3-5: the normal)
        _require(torch.equal(got.tri_attr_t[..., keep].cpu(), want.tri_attr_t[..., keep])
                 and torch.equal(got.sph_attr_t.cpu(), want.sph_attr_t)
                 and torch.equal(got.sph_sh_t.cpu(), want.sph_sh_t),
                 f"[bins] {label}: a copied row differs from the twin's")
        for name, a, b in (("normals", got.tri_attr_t[..., 3:6], want.tri_attr_t[..., 3:6]),
                           ("tri_sh_t", got.tri_sh_t, want.tri_sh_t)):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-4, msg=name)
            bin_err = max(bin_err, (a.cpu() - b).abs().max().item())
        args, kwd = fwd_tiled.kernel_inputs(pd, cam_d, got, **gkw)
        want_args, _ = fwd_tiled.kernel_inputs(pc, cam_c, want, **gkw)
        _require(torch.equal(args[0].cpu(), want_args[0]), f"[bins] {label}: params")
        dev_ = []
        for i in (2, 4):
            g, r = args[i].cpu(), want_args[i]
            dev_.append(((g - r).abs() / (1e-4 + 1e-5 * r.abs())).max().item())
            gather_err = max(gather_err, (g - r).abs().max().item())
        worst_coef = max(worst_coef, *dev_)
        frame = fwd_tiled.tiled_kernel(*args, **kwd)
        twin_tables = fwd_tiled.tiled_kernel(*[a.to(dev) for a in want_args], **kwd)
        torch.cuda.synchronize()
        _check_twin(f"[bins] {label}: B1 on the kernels' tables vs on the twin's",
                    frame, twin_tables, "packed")
        print(f"[bins] {label}: lists, counts, overflow equal "
              f"({int(got.counts[:, :2].sum())} primary, "
              f"{int(got.counts[:, 2:].sum())} shadow entries); coefficient "
              f"tables' largest deviation {dev_[0]:.3f} / {dev_[1]:.3f} of the "
              f"rtol 1e-5 / atol 1e-4 bar (tri / sph)")
    nb, ng = tracing.counter("launch.bin"), tracing.counter("launch.gather")
    _require(nb == len(cams) and ng == len(cams),
             f"[bins] launch.bin {nb}, launch.gather {ng}")
    print(f"[bins] launch.bin {nb}, launch.gather {ng}; coefficient tables at most "
          f"{worst_coef:.3f} of the bar")
    _require(worst_coef <= 1.0, f"[bins] a coefficient table is {worst_coef:.3f} "
             "of the rtol 1e-5 / atol 1e-4 bar from the twin's")

    # each wrapper's device time a call, beside its twin's on the card and
    # the bytes' bound; the rows report the pinhole frame (the fly's kind)
    timed = {}
    for label, cam_d, _ in (cams[0], cams[1]):
        pd = scene_d.pack()
        sizes = fwd_tiled._bin_sizes(pd, height=h, width=w, k=cfg.cull_k,
                                     shadows=True, shadow_k=cfg.shadow_cull_k,
                                     projective=cam_d.normalize)
        b = fwd_tiled.bin_scene(pd, camera=cam_d, **kw)
        args = fwd_tiled.kernel_inputs(pd, cam_d, b, **gkw)[0]
        shape = (f"1920x1080 10sph+1cube phong+shadows, {label}; K {b.k_tri} / "
                 f"{b.k_sph}, shadow K {b.k_sh_tri} / {b.k_sh_sph}")
        scene_in = P.nbytes(pd.tri_v0, pd.tri_e1, pd.tri_e2, pd.sph_origin,
                            pd.sph_radius)
        lists = P.nbytes(b.t_idx, b.t_valid, b.s_idx, b.s_valid)
        bin_bytes = (scene_in + P.nbytes(pd.tri_colour, pd.sph_colour) + lists
                     + P.nbytes(b.tri_attr_t, b.sph_attr_t, b.tri_sh_t,
                                b.sph_sh_t, b.counts))
        gather_bytes = scene_in + lists + P.nbytes(args[0], args[2], args[4])
        for name, fn, twin, moved in (
            ("bin", lambda pd=pd, c=cam_d: fwd_tiled.bin_scene(pd, camera=c, **kw),
             lambda pd=pd, c=cam_d, sz=sizes: fwd_tiled._bin_scene_plain(pd, c, **sz),
             bin_bytes),
            ("gather", lambda pd=pd, c=cam_d, b=b: fwd_tiled.kernel_inputs(pd, c, b, **gkw),
             lambda pd=pd, c=cam_d, b=b: fwd_tiled._gather_plain(pd, c, b),
             gather_bytes),
        ):
            bound_ms, by = P.bound(0, moved)
            ms, t_ms = device_ms(fn, 50), device_ms(twin, 20)
            timed[name, label] = (ms, t_ms, bound_ms, by, shape)
            print(f"[time] {name}, {label} 1080p: device {ms:.4f} ms a call behind "
                  f"a spin; bound {bound_ms:.6f} ms by {by} ({moved} B); the twin "
                  f"on the card {t_ms:.4f} ms behind a spin; {smi}")
    cull = _b1_cull_check(T, dev, smi)
    soft = _soft_bin_check(T, dev, smi)
    print(f"[bins] phase 19 took {time.perf_counter() - t_phase:.1f} s")

    src = "opencl_ray_tracer_tpu_torch/kernels/csrc/bin_tiled.cu"
    ms_is = ("device time per call of the wrapper ({}), behind a spin, at the "
             "pinhole 0 frame (ortho: {:.4f} ms, the [time] lines)")
    rows = []
    for name, counter, replaces, err, tol, kernels in (
        ("bin_tiled", "bin", "opencl_ray_tracer_tpu/kernels/fwd_tiled.py:1092",
         bin_err, "lists, counts, overflow and copied rows equal to the twin's; "
         "normals and shadow planes within rtol 1e-5 / atol 1e-4",
         "bin_prep_kernel then bin_tiles_kernel"),
        ("gather_tiled", "gather", "opencl_ray_tracer_tpu/kernels/fwd_tiled.py:1248",
         gather_err, "params equal to the twin's; coefficient tables within "
         "rtol 1e-5 / atol 1e-4", "gather_kernel"),
    ):
        ms, t_ms, bound_ms, by, shape = timed[counter, "pinhole 0"]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "counter": counter, "launches": {"bin": nb, "gather": ng}[counter],
            "max_abs_err": err, "tolerance": tol, "shape": shape,
            "ms": ms, "ms_is": ms_is.format(kernels, timed[counter, "ortho"][0]),
            "plain_ms": t_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None,
        })
    ms, t_ms, bound_ms, by, shape = soft["timed"]["rt10"]
    rows.append({
        "name": "bin_soft", "route": "cuda", "source": src,
        "replaces": "opencl_ray_tracer_tpu/kernels/soft_tiled.py:233",
        "counter": "bin_soft", "launches": soft["direct"] + soft["step"],
        "launches_by_path": {"phase 19": soft["direct"],
                             "phase 19 step": soft["step"]},
        "max_abs_err": 0.0, "tolerance": "every list, mask, count and the "
        "overflow flag equal to the twin's on the same tensors",
        "shape": shape, "ms": ms,
        "ms_is": ("device time per call of the wrapper (bin_soft_prep_kernel "
                  "then bin_soft_tiles_kernel), behind a spin; scene 3 1080p "
                  f"ortho K 96 / 136: {soft['timed']['scene3'][0]:.4f} ms, twin "
                  f"{soft['timed']['scene3'][1]:.4f} ms"),
        "plain_ms": t_ms, "bound_ms": bound_ms, "bound_by": by,
        "library_ms": None,
    })
    return rows, cull


def _b1_cull_check(T, dev, smi, w=1920, h=1080):
    """Phase 19's B1 on the pinhole shadow rows that its warps cull, at the
    frame of the scene3_1080_hard.fly cell: scene 3 (1,300 primitives,
    every light's list the whole scene) through a pinhole camera of the
    orbit at 1920x1080, phong + hard shadows, packed words, binned at K
    256 / 512 (no list overflows). The counters zeroed just before one
    launch, B1's frame against `_tiled_kernel_plain`'s (the whole walk) on
    the same card tensors at the hard bars, `b1.shadow_rows` > 0 and the
    kept share strictly inside (0, 100) from that launch; then B1's device
    time a launch behind a spin beside the twin's. Returns the record of
    the `kernels` line's `pinhole_cull` entry."""
    import torch

    from opencl_ray_tracer_tpu_torch.bench_util import device_ms
    from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled
    from opencl_ray_tracer_tpu_torch.utils import tracing

    cam = _orbit_pinhole(T, dev, 30, w, h)
    cfg = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                         framebuffer_dtype="packed", cull_k=256, shadow_cull_k=512)
    packed = T.create_scene(3, seed=0, device=dev).pack()
    bins = fwd_tiled.bin_for_config(packed, cam, cfg)
    _require(max(bins.k_tri, bins.k_sph) <= 256 and not bool(bins.overflow),
             f"[cull] scene 3 overflows K 256 / 512: K {bins.k_tri} / {bins.k_sph}")
    args, kw = fwd_tiled.kernel_inputs(packed, cam, bins, height=h, width=w,
                                       shading="phong", shadows=True,
                                       out_format="packed")
    tracing.reset()
    got = fwd_tiled.tiled_kernel(*args, **kw)
    torch.cuda.synchronize()
    rows, kept = (tracing.counter(n) for n in fwd_tiled._CULL_COUNTERS)
    label = (f"scene 3 {w}x{h} pinhole 30 phong+shadows, K {bins.k_tri} / "
             f"{bins.k_sph}, shadow tables {bins.k_sh_tri} + {bins.k_sh_sph} rows")
    err = _check_twin(f"[cull] {label}: B1 (culled walk) vs twin (whole walk)",
                      got, fwd_tiled._tiled_kernel_plain(*args, **kw), "packed")
    _require(rows > 0 and 0 < kept < rows,
             f"[cull] b1.shadow_rows {rows}, b1.shadow_rows_kept {kept}")
    ms = device_ms(lambda: fwd_tiled.tiled_kernel(*args, **kw), 50)
    t_ms = device_ms(lambda: fwd_tiled._tiled_kernel_plain(*args, **kw), 3)
    pct = 100.0 * kept / rows
    print(f"[cull] {label}: b1.shadow_rows {rows}, kept {kept} ({pct:.4f}%) in "
          f"one launch; B1 {ms:.4f} ms of device time a launch behind a spin, "
          f"the twin on the card {t_ms:.4f} ms; {smi}")
    return {"shape": label, "max_abs_err": err, "shadow_rows": rows,
            "shadow_rows_kept": kept, "kept_pct": pct, "ms": ms, "plain_ms": t_ms,
            "ms_is": "device time per launch, behind a spin"}


def _soft_bin_check(T, dev, smi):
    """Phase 19's soft binning (`soft_tiled._bin_soft` on the card: the
    two kernels of `_bin_soft_cuda`) at the fit cells' frames: the rt10_1080
    frame (10 spheres + 1 cube, phong + soft shadows, K 32 / 64) and scene
    3 at 1080p (K 96 / 136), legacy ortho camera, tau_edge 0.5. Every field
    equal to `_bin_soft_plain`'s on the same tensors; each side's device
    time a call behind a spin, beside the bytes' bound. Then the main
    path's launches: five steps of make_train_step(jit=True) at the rt10
    frame, where the capture's two warm-up runs launch from the host and the
    capture and the replays count none. Returns {"timed": {name: (ms,
    twin ms, bound ms, bound by, shape)}, "direct": host launches of the
    checks and timings, "step": the step's}."""
    import torch

    from opencl_ray_tracer_tpu_torch.bench_util import device_ms
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S
    from opencl_ray_tracer_tpu_torch.parallel import (
        adam,
        init_train_state,
        make_train_step,
    )
    from opencl_ray_tracer_tpu_torch.runtime.graph import device_scalar
    from opencl_ray_tracer_tpu_torch.utils import profiling as P
    from opencl_ray_tracer_tpu_torch.utils import tracing

    w, h = 1920, 1080
    cam = T.legacy_ortho_camera(device=dev)
    fields = ("t_idx", "t_valid", "s_idx", "s_valid", "tsh_idx", "tsh_valid",
              "ssh_idx", "ssh_valid", "counts", "overflow")
    tracing.reset()
    timed = {}
    for name, n_sph, n_cubes, k, sk in (("rt10", 10, 1, 32, 64),
                                        ("scene3", 100, 100, 96, 136)):
        pd = T.random_scene(n_sph, n_cubes, seed=0, bounds=(1910.0, 1070.0),
                            device=dev).pack()
        kw = dict(height=h, width=w, k=k, shadows=True, shadow_k=sk)
        sizes = S._soft_bin_sizes(pd, projective=False, **kw)
        tau = device_scalar(0.5, dev)
        got = S._bin_soft(pd, tau, cam, **kw)
        want = S._bin_soft_plain(pd, tau, cam, **sizes)
        for f in fields:
            _require(torch.equal(getattr(got, f), getattr(want, f)),
                     f"[bin_soft] {name}: {f} differs from the twin's")
        _require(not bool(got.overflow), f"[bin_soft] {name}: a list overflows")
        shape = (f"1920x1080 {n_sph}sph+{n_cubes}cube phong + soft shadows, "
                 f"ortho, tau_edge 0.5; K {got.k_tri} / {got.k_sph}, shadow K "
                 f"{got.k_sh_tri} / {got.k_sh_sph}")
        moved = (P.nbytes(pd.tri_v0, pd.tri_e1, pd.tri_e2, pd.sph_origin,
                          pd.sph_radius)
                 + sum(P.nbytes(getattr(got, f)) for f in fields))
        bound_ms, by = P.bound(0, moved)
        ms = device_ms(lambda pd=pd, kw=kw, tau=tau: S._bin_soft(pd, tau, cam, **kw), 50)
        t_ms = device_ms(lambda pd=pd, sz=sizes, tau=tau:
                         S._bin_soft_plain(pd, tau, cam, **sz), 20)
        timed[name] = (ms, t_ms, bound_ms, by, shape)
        print(f"[bin_soft] {name}: lists, counts, overflow equal to the twin's "
              f"({int(got.counts[:, :2].sum())} primary, "
              f"{int(got.counts[:, 2:].sum())} shadow entries); device {ms:.4f} "
              f"ms a call behind a spin, the twin {t_ms:.4f} ms; bound "
              f"{bound_ms:.6f} ms by {by} ({moved} B); {shape}; {smi}")
    direct = tracing.counter("launch.bin_soft")
    # each frame: the checked call, then device_ms' warm-up call and its 50
    _require(direct == 2 * 52, f"[bin_soft] launch.bin_soft {direct}, not 104")

    tracing.reset()
    cfg = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                         soft=True, framebuffer_dtype="float", tau_depth=1.0,
                         tau_edge=0.5)
    scene = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
    optimizer = adam(0.5)
    step = make_train_step(cam, cfg, optimizer, jit=True)
    state = init_train_state(scene, optimizer)
    target = torch.zeros((h, w, 4), device=dev)
    for _ in range(5):
        state, loss = step(state, target)
    torch.cuda.synchronize()
    n_step = tracing.counter("launch.bin_soft")
    replays = tracing.counter("graph.replays.train step")
    print(f"[bin_soft] main path: 5 compiled train steps at the rt10 frame: "
          f"launch.bin_soft {n_step} (the capture's warm-up runs), "
          f"{replays} replays (each bins once on the card, uncounted); loss "
          f"{loss.item():.6g}")
    _require(n_step == 2 and replays == 5,
             f"[bin_soft] the compiled step launched {n_step}, replayed {replays}")
    return {"timed": timed, "direct": direct, "step": n_step}


if __name__ == "__main__":
    sys.exit(main())
