"""The list of non-empty tiles that the tiled forward kernels B1/B2
(`fwd_tiled.tiled_kernel`) and B4 (`soft_tiled.soft_tiled_fwd`) build on
the card and launch blocks for, in its plain version
(`fwd_tiled._live_tiles`), against a direct walk over the counts of the
hard and the soft bins: a frame with no candidate in any tile, a frame whose
every tile holds candidates, and a frame that is not a whole number of
tiles. On the CPU the kernels' wrappers run their plain twins, which skip
the same tiles: an empty tile holds the background."""

import dataclasses

import pytest
import torch

import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled as F
from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S

torch.set_num_threads(2)

CPU = torch.device("cpu")
CAM = T.legacy_ortho_camera(device=CPU)


def _frame(kind):
    """(scene, width, height): every primitive beyond the frame's right edge
    ("empty"), scene 3 filling a 640x480 frame ("full"), or the test scene
    at 300x170 (right and bottom tiles cut by the frame's edge, the scene in
    the top left 250 x 120)."""
    if kind == "full":
        return T.create_scene(3, seed=0, device=CPU), 640, 480
    scene = T.random_scene(5, 3, seed=4, bounds=(250.0, 120.0), device=CPU)
    if kind == "empty":
        shift = torch.tensor([5000.0, 0.0, 0.0])
        scene = dataclasses.replace(scene, sphere_origin=scene.sphere_origin + shift,
                                    tri_verts=scene.tri_verts + shift)
        return scene, 250, 123
    return scene, 300, 170


def _counts(kind, soft):
    scene, w, h = _frame(kind)
    cfg = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                         soft=soft, framebuffer_dtype="float", tau_depth=1.0,
                         tau_edge=0.5)
    packed = scene.pack()
    if soft:
        bins = S.soft_bins_for_config(packed, CAM, cfg)
    else:
        bins = F.bin_for_config(packed, CAM, cfg)
    return bins.counts, bins.nty * bins.ntx, (scene, cfg)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("kind", ["empty", "full", "ragged"])
def test_live_tiles_match_direct_walk(kind, soft):
    counts, n_tiles, _ = _counts(kind, soft)
    want = [t for t in range(n_tiles) if int(counts[t, 0]) + int(counts[t, 1]) > 0]
    got = F._live_tiles(counts)
    assert got.dtype == torch.int64 and got.tolist() == want
    if kind == "empty":
        assert want == []
    if kind == "full":
        assert want == list(range(n_tiles)) and n_tiles == 40
    if kind == "ragged":  # 3 x 3 tiles, the scene in some of them
        assert n_tiles == 9 and 0 < len(want) < 9


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_empty_frame_is_background(soft):
    """A frame with no candidate anywhere: every pixel is the background."""
    _, _, (scene, cfg) = _counts("empty", soft)
    if soft:
        with torch.no_grad():
            img = S.render_soft_tiled(scene, CAM, cfg)
        bg = torch.tensor([0.0, 0.0, 0.0, 255.0])
        assert img.shape == (123, 250, 4) and bool((img == bg).all())
    else:
        img = F.render_tiled(scene, CAM, cfg.replace(framebuffer_dtype="packed"))
        assert img.shape == (123, 250) and bool((img == -16777216).all())
