"""Hard frames whose tile lists overflow, and the benchmark's hard-frame
cells beside `rt10_1080.fly`: `scene3_1080_hard.fly` (scene 3 flown through
with `models.renderer.render`, every frame re-run at doubled K caps),
`rt10_1080.fly_jit` (the compiled frame, `models.renderer.render_jit`) and
`scene3_1080_hard.fly_jit` (the compiled frame on scene 3, whose brute
branch B3 renders every frame).

On the CPU, at 160 x 120: scene 3's distributions with 12 spheres and 4
cubes over the frame, seen by the cells' pinhole orbit scaled to the frame,
at cull_k 8, so that every frame's lists overflow and the frame runs two to
four times. Each frame is held against the benchmark's plain reference
(`rtbench/reference/hard.py`) by the cells' own check
(`frames.mismatch_share`) and limit; a frame from the truncated K 8 lists,
with no re-binning, reads above that limit. The card tests skip here."""

import argparse
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from opencl_ray_tracer_tpu_torch import RenderConfig, pinhole_camera  # noqa: E402
from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled  # noqa: E402
from opencl_ray_tracer_tpu_torch.models.renderer import render  # noqa: E402
from opencl_ray_tracer_tpu_torch.runtime import graph  # noqa: E402
from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays  # noqa: E402
from opencl_ray_tracer_tpu_torch.utils import tracing  # noqa: E402
from rtbench.lib import files, scenes  # noqa: E402
from rtbench.lib.main import execute  # noqa: E402
from rtbench.reference import hard  # noqa: E402

torch.set_num_threads(2)

W, H = 160, 120
SX, SY = W / 1920.0, H / 1080.0
# scene3_1080_hard's scene block, its bounds and light scaled to the frame
SCENE = {"generator": "random_scene", "n_spheres": 12, "n_cubes": 4,
         "bounds": [1910.0 * SX, 1070.0 * SY],
         "lights": {"position": [[200.0 * SX, 100.0 * SY, 200.0]],
                    "colour": [[1.0, 1.0, 1.0]], "intensity": [1.0],
                    "ambient": 0.1, "spec_strength": 0.5, "shininess": 32.0},
         "layout_seed": 0}
# fly.json's orbit scaled to the frame, 12 frames a turn
ORBIT = {"centre": [955.0 * SX, 535.0 * SY, -60.0], "radius": 900.0 * SX,
         "height_offset": -120.0 * SY, "fov_degrees": 60.0, "frames_per_turn": 12}
# the cells' hard mode at K 8: 48 triangles and 12 spheres over 2 x 2 tiles
MODE = dict(files.config(files.benchmark(), "scene3_1080_hard")["modes"]["hard"],
            cull_k=8, shadow_cull_k=8)
SEED = 2 ** 31 + 613
LIMIT = files.limits("scene3_1080_hard.fly")["frame_mismatch_share"]
CAMS = [0, 3, 6, 9]

frames = files.load("loops", "frames")


def _inputs(k):
    arrays = scenes.make_scene(SCENE, SEED, "cpu")
    cam = frames.orbit_cameras(ORBIT, W, H)[k]
    program_cam = pinhole_camera(position=cam["position"], look_at=cam["look_at"],
                                 up=cam["up"], fov_degrees=cam["fov_degrees"],
                                 width=W, height=H, device="cpu")
    cfg = RenderConfig(width=W, height=H, **MODE).validate()
    return arrays, scene_from_arrays(arrays, "cpu"), cam, program_cam, cfg


def _reference(arrays, cam):
    return hard.render(arrays, cam, H, W, MODE["shading"], MODE["shadows"])


def _runs_wanted(scene, program_cam, cfg):
    """1 + the doublings of K from cull_k until the longest primary list
    fits (the pinhole camera's shadow lists hold every primitive)."""
    packed = scene.pack()
    full = fwd_tiled.bin_scene(packed, height=H, width=W, k=1 << 12, shadows=True,
                               camera=program_cam)
    longest = int(full.counts[:, :2].max())
    k_max = fwd_tiled._round_up(max(packed.n_tris, packed.n_spheres), fwd_tiled.CHUNK)
    k, runs = cfg.cull_k, 1
    while k < longest:
        k, runs = min(2 * k, k_max), runs + 1
    return runs


@pytest.fixture
def clean():
    tracing.reset()
    yield
    tracing.reset()


@pytest.mark.parametrize("k", CAMS)
def test_overflowing_pinhole_frame_matches_the_reference(clean, k):
    arrays, scene, cam, program_cam, cfg = _inputs(k)
    assert bool(fwd_tiled.bin_fixed(scene.pack(), program_cam, cfg).overflow)
    words = render(scene, program_cam, cfg)
    assert words.shape == (H, W) and words.dtype == torch.int32
    share = frames.mismatch_share(words, _reference(arrays, cam))
    assert share <= LIMIT, share


@pytest.mark.parametrize("k", CAMS)
def test_frame_runs_counts_one_run_and_one_a_doubling(clean, k):
    _, scene, _, program_cam, cfg = _inputs(k)
    want = _runs_wanted(scene, program_cam, cfg)
    assert want >= 3  # K 8 -> 16 -> 32 at least
    render(scene, program_cam, cfg)
    c = tracing.snapshot()["counters"]
    assert (c["frame.runs"], c["frame.eager"], c["frame.rebinned"]) == (want, 1, 1)
    # at caps that hold every list the frame runs once
    render(scene, program_cam, cfg.replace(cull_k=64, shadow_cull_k=64))
    c = tracing.snapshot()["counters"]
    assert (c["frame.runs"], c["frame.eager"], c["frame.rebinned"]) == (want + 1, 2, 1)


def test_frames_from_truncated_lists_read_above_the_limit(clean):
    """The fault a skipped escalation makes: each frame rendered from its
    K 8 bins as they are, lists truncated, reads above the cells' limit by
    the check's own measure (the worst frame, as the check takes it)."""
    worst = 0.0
    for k in CAMS:
        arrays, scene, cam, program_cam, cfg = _inputs(k)
        packed = scene.pack()
        bins = fwd_tiled.bin_fixed(packed, program_cam, cfg)
        assert bool(bins.overflow)
        words = fwd_tiled._frame_from_bins(packed, program_cam, cfg, bins)
        worst = max(worst, frames.mismatch_share(words, _reference(arrays, cam)))
    assert worst > LIMIT, worst


def test_a_rerun_is_logged_once_a_config_and_k_pair(clean, monkeypatch):
    logged = []
    monkeypatch.setattr(fwd_tiled, "log_warning",
                        lambda msg, *a: logged.append(a))
    monkeypatch.setattr(fwd_tiled, "_WARNED", set())
    _, scene, _, program_cam, cfg = _inputs(CAMS[0])
    want = _runs_wanted(scene, program_cam, cfg)
    for _ in range(3):
        render(scene, program_cam, cfg)
    assert tracing.counter("frame.runs") == 3 * want
    # one line a doubled pair, at the first frame only
    assert len(logged) == want - 1 and len(set(logged)) == want - 1
    render(scene, program_cam, cfg.replace(shading="lambert"))  # a new config
    assert len(logged) == 2 * (want - 1)


def _args(workload, trace, seconds=0.6):
    return argparse.Namespace(workload=workload, seed=SEED, seconds=seconds,
                              trace=trace)


SMALL_TRAFFIC = {"orbit": ORBIT, "warmup_seconds": 0.0, "check_frames": 3,
                 "trace_units": 3}
RT10_SMALL = {"width": 128, "height": 64,
              "scene": {"generator": "random_scene", "n_spheres": 6, "n_cubes": 1,
                        "bounds": [120.0, 60.0], "layout_seed": 3,
                        "lights": SCENE["lights"]}}
DENSE = {"width": W, "height": H, "scene": SCENE, "modes": {"hard": MODE}}
CELLS = {
    # scene 3's density at K 8: every frame runs again
    "scene3_1080_hard.fly": DENSE,
    # rt10 cut to 128 x 64: no list overflows K 32
    "rt10_1080.fly": RT10_SMALL,
    "rt10_1080.fly_jit": RT10_SMALL,
    # the compiled frame on lists that overflow K 8: the brute branch
    "rt10_1080.fly_jit-dense": DENSE,
    "scene3_1080_hard.fly_jit": DENSE,
}


def _traced_seconds(workload, over):
    """A window in whose second half a frame surely ends, so that the traced
    stretch starts there (`rtbench/lib/window.py`): six times the longest
    frame of a one-frame run of the cell timed now, under the CPU's load of
    the moment, and at least 4 s. A dense frame takes up to ~1 s on a loaded
    CPU, and the load changes while the workers run."""
    _, _, run = execute(_args(workload, 0, 0.0), torch.device("cpu"), overrides=over)
    return max(4.0, 6.0 * max(run.window["latencies_s"]))


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_the_hard_frame_cells_run_and_report(clean, cell, trace):
    workload = cell.split("-")[0]
    over = {"config": CELLS[cell], "traffic": SMALL_TRAFFIC}
    seconds = _traced_seconds(workload, over) if trace else 0.6
    res, checks, run = execute(_args(workload, trace, seconds),
                               torch.device("cpu"), overrides=over)
    assert res["correct"] is True, checks
    assert [c[0] for c in checks] == ["frame_mismatch_share"]
    assert res["attempted"] > 0
    got = set(res["metrics"])
    if not trace:
        assert got == {"frame_p95_ms", "setup_s"}
        assert res["metrics"]["frame_p95_ms"]["value"] > 0
        return
    assert {"frame.mean_ms", "frame.device_ops", "frame.idle_pct"} <= got
    # a CPU trace holds no device operation, so no B1 or B3 to read; the
    # compiled frame's cond and B3's counters count on the card only
    assert not {"frame.b1_roofline", "frame.brute_pct", "frame.b3_roofline",
                "frame.b3_hit_pct"} & got
    if workload.endswith(".fly_jit"):
        assert "frame.runs_per_frame" not in got and "frame.replay_pct" not in got
        return
    runs = res["metrics"]["frame.runs_per_frame"]
    assert runs["unit"] == "runs/frame"
    assert res["metrics"]["frame.replay_pct"]["value"] == 0.0  # CPU frames
    if workload == "rt10_1080.fly":
        assert runs["value"] == 1.0
    else:
        assert runs["value"] >= 3.0


def _counted(counters):
    class _Run:
        def memo(self, key, make):
            return {"counters": counters}

    return files.load("metrics", "frame.brute_pct").read(_Run())


def test_the_brute_share_reads_the_cond_counter_over_the_replays():
    assert _counted({"cond.fwd_tiled.frame.brute": 0,
                     "graph.replays.render_tiled_fixed": 40}) == 0.0
    assert _counted({"cond.fwd_tiled.frame.brute": 10,
                     "graph.replays.render_tiled_fixed": 40}) == 25.0
    # a program whose cond names no site, or that replayed nothing
    assert _counted({"graph.replays.render_tiled_fixed": 40}) is None
    assert _counted({"cond.fwd_tiled.frame.brute": 0}) is None


def _hit_pct(counters):
    class _Run:
        def memo(self, key, make):
            return {"counters": counters}

    return files.load("metrics", "frame.b3_hit_pct").read(_Run())


def test_the_brute_hit_share_reads_b3s_counters():
    assert _hit_pct({"b3.px": 2_073_600, "b3.hit_px": 518_400}) == 25.0
    assert _hit_pct({"b3.px": 100, "b3.hit_px": 0}) == 0.0
    # a program without B3's counters, or a run in which B3 never ran
    assert _hit_pct({"graph.replays.render_tiled_fixed": 40}) is None
    assert _hit_pct({"b3.px": 0, "b3.hit_px": 0}) is None


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels and CUDA graphs have no "
                    "CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cull_k", [8, 64])
def test_compiled_frame_counts_its_brute_replays(card, clean, cull_k):
    """`render_jit`'s cond (`fwd_tiled.frame`) adds one to
    `cond.fwd_tiled.frame.brute` a replay where the lists overflow (K 8) and
    nothing where they fit (K 64); the frames match the reference."""
    from opencl_ray_tracer_tpu_torch.models.renderer import render_jit

    arrays = scenes.make_scene(SCENE, SEED, card)
    scene = scene_from_arrays(arrays, card)
    cfg = RenderConfig(width=W, height=H, **dict(MODE, cull_k=cull_k,
                                                 shadow_cull_k=cull_k)).validate()
    fwd = render_jit(cfg)
    cams = frames.orbit_cameras(ORBIT, W, H)
    for k in CAMS:
        c = cams[k]
        pc = pinhole_camera(position=c["position"], look_at=c["look_at"],
                            up=c["up"], fov_degrees=c["fov_degrees"], width=W,
                            height=H, device=card)
        assert bool(fwd_tiled.bin_fixed(scene.pack(), pc, cfg).overflow) == (cull_k == 8)
        words = fwd(scene, pc).clone()
        share = frames.mismatch_share(words, hard.render(arrays, c, H, W,
                                                         MODE["shading"],
                                                         MODE["shadows"]))
        assert share <= LIMIT, (k, share)
    replays = tracing.counter("graph.replays.render_tiled_fixed")
    assert replays == len(CAMS)
    assert tracing.counter("cond.fwd_tiled.frame.brute") == (
        replays if cull_k == 8 else 0)


def test_overflowing_frames_rerun_on_the_card(card, clean, monkeypatch):
    """render() on the card, eager then replayed at every K pair: the frames
    match the reference and `frame.runs` counts each run."""
    monkeypatch.setattr(fwd_tiled, "_FRAME_GRAPHS", graph.GraphCache("render_tiled"))
    arrays = scenes.make_scene(SCENE, SEED, card)
    scene = scene_from_arrays(arrays, card)
    cfg = RenderConfig(width=W, height=H, **MODE).validate()
    cams = frames.orbit_cameras(ORBIT, W, H)
    want = 0
    for rep in range(3):
        for k in CAMS:
            c = cams[k]
            pc = pinhole_camera(position=c["position"], look_at=c["look_at"],
                                up=c["up"], fov_degrees=c["fov_degrees"], width=W,
                                height=H, device=card)
            want += _runs_wanted(scene, pc, cfg)
            words = render(scene, pc, cfg)
            share = frames.mismatch_share(words, hard.render(
                arrays, c, H, W, MODE["shading"], MODE["shadows"]))
            assert share <= LIMIT, (rep, k, share)
    assert tracing.counter("frame.runs") == want
    assert tracing.counter("frame.replayed") > 0


def test_b3_counts_its_pixels_eager_and_replayed_and_leaves_the_words(card, clean,
                                                                       monkeypatch):
    """B3 adds the frame's pixels to `b3.px` and those that hit something to
    `b3.hit_px` at every launch that runs: eager, in the compiled frame's
    warm-up, and replayed (the brute branch at K 8); the words are those of
    B3 launched with no counters."""
    from opencl_ray_tracer_tpu_torch.kernels import fwd
    from opencl_ray_tracer_tpu_torch.models.renderer import render_jit
    from opencl_ray_tracer_tpu_torch.ops.shading import pack_framebuffer_words

    arrays = scenes.make_scene(SCENE, SEED, card)
    scene = scene_from_arrays(arrays, card)
    cfg = RenderConfig(width=W, height=H, **MODE).validate()
    c = frames.orbit_cameras(ORBIT, W, H)[CAMS[1]]
    pc = pinhole_camera(position=c["position"], look_at=c["look_at"], up=c["up"],
                        fov_degrees=c["fov_degrees"], width=W, height=H, device=card)

    def brute():
        return fwd._render_pallas_jit(scene.pack(), pc, height=H, width=W,
                                      shading=MODE["shading"], shadows=MODE["shadows"])

    def counts():
        return [tracing.counter(n) for n in fwd._B3_COUNTERS]

    rgba = brute()
    px, hit = counts()
    assert px == W * H
    assert hit == int((rgba[..., :3] != 0).any(-1).sum()) > 0
    with monkeypatch.context() as m:  # no counters: the kernel gets none
        m.setattr(fwd.tracing, "device_counters", lambda *a, **kw: None)
        bare = brute()
    assert counts() == [px, hit]
    assert torch.equal(rgba, bare)

    fwd_jit = render_jit(cfg)
    fwd_jit(scene, pc)  # warm-up (B3 under run_if, taken), capture, replay
    tracing.reset()
    for n in range(1, 4):
        words = fwd_jit(scene, pc).clone()
        torch.cuda.synchronize(card)
        assert counts() == [n * px, n * hit]
        assert torch.equal(words, pack_framebuffer_words(bare))
    assert tracing.counter("cond.fwd_tiled.frame.brute") == 3
