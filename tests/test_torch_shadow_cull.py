"""B1's per-warp cull of the pinhole shadow rows, in its plain form
(`fwd_tiled._shadow_keep_plain`), on the CPU.

The cull may keep too much and never too little: a row that the walk's own
test (`_tri_blocked`, `_sph_blocked`) marks blocked for a hit point of the
warp's box has to be kept, or a pixel that the whole walk shadows would be
lit. The first test samples points on and about the rows' boundaries (a
triangle's light frustum, a sphere's tangents from the light), inside small
and large boxes; the second walks only the kept rows of each 8 x 4 patch of
a scene-3 pinhole frame and compares its occlusion with the whole walk's.
"""

import types

import pytest
import torch

import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu_torch.kernels import fwd, fwd_tiled
from opencl_ray_tracer_tpu_torch.ops.intersect import MISS_T

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _u(g, *shape, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=g)


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _boxes(g, q):
    """Boxes about the points q (B, 3): q inside, on a face or at a corner;
    extents from a point to tens of units."""
    b = q.shape[0]
    h = _u(g, b, 3) * torch.tensor([0.0, 1e-3, 0.5, 5.0, 40.0])[
        torch.randint(5, (b, 1), generator=g)]
    side = torch.randint(3, (b, 3), generator=g).float() - 1.0  # -1, 0, 1
    lo = q - h * (1.0 + side).clamp(max=1.0)
    hi = q + h * (1.0 - side).clamp(max=1.0)
    return lo, hi


def _walk_points(g, lo, hi, o0, extra):
    """Samples of each box (B, S, 3) as B1 computes them: the corners, the
    centre, random points and `extra` (B, 3), each taken as a ray from the
    camera at o0 and rebuilt as o0 + t rd. The box is widened to hold the
    rebuilt points (their rounding), as B1's box holds its lanes' points."""
    b = lo.shape[0]
    corners = torch.stack([torch.where(torch.tensor([(k >> i) & 1 for i in range(3)],
                                                    dtype=torch.bool), hi, lo)
                           for k in range(8)], 1)
    rand = lo[:, None] + (hi - lo)[:, None] * _u(g, b, 16, 3)
    pts = torch.cat([corners, ((lo + hi) / 2)[:, None], rand,
                     torch.minimum(torch.maximum(extra, lo), hi)[:, None]], 1)
    d = pts - o0
    t = torch.linalg.vector_norm(d, dim=-1)
    rd = d / t[..., None]
    p = o0 + t[..., None] * rd
    lo = torch.minimum(lo, p.amin(1))
    hi = torch.maximum(hi, p.amax(1))
    return p, t, rd, lo, hi


def _light_terms(p, light):
    """B1's `shade`: the unit direction to the light and its distance."""
    tl = light - p
    tl2 = torch.clamp((tl * tl).sum(-1), min=1e-20)
    rinv = 1.0 / torch.sqrt(tl2)
    return tl * rinv[..., None], tl2 * rinv


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cull_keeps_every_row_that_blocks_a_point_of_the_box(seed):
    g = torch.Generator().manual_seed(seed)
    n = 1024
    light = torch.stack([_u(g, lo=-300.0, hi=900.0), _u(g, lo=-300.0, hi=700.0),
                         _u(g, lo=50.0, hi=500.0)])
    o0 = torch.stack([_u(g, lo=0.0, hi=640.0), _u(g, lo=0.0, hi=480.0),
                      _u(g, lo=60.0, hi=900.0)])
    jitter = torch.tensor([0.0, 1e-5, -1e-5, 1e-3, -1e-3, 1e-2, -1e-2, 0.3, -0.3])

    # triangles in the slab, and points on their light frustums' boundaries:
    # behind an edge (a side plane), a vertex (two) or the face (the
    # triangle's plane, whose threshold is SH_PLANE_EPS), then off it
    v0 = torch.stack([_u(g, n, lo=0.0, hi=640.0), _u(g, n, lo=0.0, hi=480.0),
                      _u(g, n, lo=-130.0, hi=-10.0)], -1)
    v1 = v0 + _u(g, n, 3, lo=-40.0, hi=40.0)
    v2 = v0 + _u(g, n, 3, lo=-40.0, hi=40.0)
    ns = types.SimpleNamespace(tri_v0=v0.T, tri_e1=(v1 - v0).T, tri_e2=(v2 - v0).T)
    rows = fwd_tiled._tri_shadow_planes(ns, light)
    w = _u(g, n, 3)
    kind = torch.randint(3, (n,), generator=g)
    w = torch.where((kind == 0)[:, None], w * torch.tensor([1.0, 1.0, 0.0]), w)
    w = torch.where((kind == 1)[:, None], torch.tensor([1.0, 0.0, 0.0]), w)
    base = (w[:, :1] * v0 + w[:, 1:2] * v1 + w[:, 2:] * v2) / w.sum(-1, keepdim=True)
    away = torch.where((kind == 2)[:, None], _u(g, n, 1, hi=0.05), _u(g, n, 1, hi=3.0))
    q = base + away * (base - light)
    q = q + jitter[torch.randint(len(jitter), (n, 1), generator=g)] * _unit(
        _u(g, n, 3, lo=-1.0, hi=1.0))
    lo, hi = _boxes(g, q)
    p, t, rd, lo, hi = _walk_points(g, lo, hi, o0, q)
    cols = [rows[:, i : i + 1] for i in range(16)]
    blocked = fwd_tiled._tri_blocked(cols, projective=True, x=None, y=None, t=t,
                                     o0=tuple(o0), rd=tuple(rd.unbind(-1)))
    keep, _ = fwd_tiled._shadow_keep_plain(rows[:, None], rows[:0], lo, hi, light, o0)
    keep = keep[:, 0]
    hit = blocked.any(1)
    assert hit.sum() > n // 8, "too few boxes test a blocking point"
    assert not (hit & ~keep).any(), f"dropped {int((hit & ~keep).sum())} blocking rows"

    # far boxes: the cull drops most rows there
    far_lo, far_hi = _boxes(g, torch.stack([_u(g, n, lo=0.0, hi=640.0),
                                            _u(g, n, lo=0.0, hi=480.0),
                                            _u(g, n, lo=-130.0, hi=0.0)], -1))
    kept, _ = fwd_tiled._shadow_keep_plain(rows, rows[:0], far_lo[:, None],
                                           far_hi[:, None], light, o0)
    assert kept.float().mean() < 0.25

    # spheres, and points whose segment to the light grazes them: beyond a
    # tangent point as the light sees it, then off it
    c = torch.stack([_u(g, n, lo=0.0, hi=640.0), _u(g, n, lo=0.0, hi=480.0),
                     _u(g, n, lo=-100.0, hi=-20.0)], -1)
    r = torch.where(torch.rand(n, generator=g) < 0.1, _u(g, n, lo=0.01, hi=1.0),
                    _u(g, n, lo=5.0, hi=30.0))
    axis = _unit(c - light)
    u = _unit(torch.linalg.cross(axis, _unit(_u(g, n, 3, lo=-1.0, hi=1.0))))
    s0 = c + r[:, None] * u
    q = light + _u(g, n, 1, lo=1.02, hi=3.0) * (s0 - light)
    q = q + jitter[torch.randint(len(jitter), (n, 1), generator=g)] * u
    srows = torch.cat([c, (r * r)[:, None], torch.zeros(n, 12)], 1)
    lo, hi = _boxes(g, q)
    p, _, _, lo, hi = _walk_points(g, lo, hi, o0, q)
    ld, dist = _light_terms(p, light)
    blocked = fwd_tiled._sph_blocked([srows[:, i : i + 1] for i in range(4)],
                                     p=tuple(p.unbind(-1)), ld=tuple(ld.unbind(-1)),
                                     dist=dist)
    _, keep = fwd_tiled._shadow_keep_plain(srows[:0], srows[:, None], lo, hi,
                                           light, o0)
    keep = keep[:, 0]
    hit = blocked.any(1)
    assert hit.sum() > n // 8, "too few boxes test a blocking point"
    assert not (hit & ~keep).any(), f"dropped {int((hit & ~keep).sum())} blocking rows"
    _, kept = fwd_tiled._shadow_keep_plain(srows[:0], srows, far_lo[:, None],
                                           far_hi[:, None], light, o0)
    assert kept.float().mean() < 0.25


def _patches(v):
    """(nb, 8192) tile pixels -> (nb, 256, 32): B1's warps, 8 x 4 patches."""
    return v.reshape(-1, 16, 4, 16, 8).permute(0, 1, 3, 2, 4).reshape(-1, 256, 32)


@pytest.mark.parametrize("n_lights", [1, 2])
def test_walking_the_kept_rows_shadows_as_the_whole_walk(monkeypatch, n_lights):
    w, h = 160, 120
    lights = T.Lights.default(CPU)
    if n_lights == 2:
        lights = T.Lights(
            position=torch.tensor([[200.0, 100.0, 200.0], [600.0, 400.0, 120.0]]),
            colour=torch.ones(2, 3), intensity=torch.tensor([0.6, 0.6]),
            ambient=lights.ambient, spec_strength=lights.spec_strength,
            shininess=lights.shininess)
    scene = T.create_scene(3, seed=0, lights=lights, device=CPU)
    cam = T.pinhole_camera((320.0, 240.0, 60.0), (320.0, 240.0, -85.0),
                           fov_degrees=80.0, width=w, height=h, device=CPU)
    cfg = T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                         framebuffer_dtype="packed")
    packed = scene.pack()
    bins = fwd_tiled.bin_for_config(packed, cam, cfg)
    args, kw = fwd_tiled.kernel_inputs(packed, cam, bins, height=h, width=w,
                                       shading="phong", shadows=True,
                                       out_format="packed")
    params = args[0]
    whole = fwd_tiled._shadow_occluded_plain
    tally = {"rows": 0, "kept": 0, "lit": 0, "calls": 0}

    def culled(tri_sh, sph_sh, n_tri, n_sph, li, tri_stride, sph_stride, ch, **k):
        occ = whole(tri_sh, sph_sh, n_tri, n_sph, li, tri_stride, sph_stride, ch, **k)
        x, y, t = k["x"], k["y"], k["t"]
        lit = _patches((t < MISS_T) & (x < w) & (y < h))
        pts = torch.stack([_patches(v) for v in k["p"]], -1)
        inf = torch.tensor(float("inf"))
        lo = torch.where(lit[..., None], pts, inf).amin(2)
        hi = torch.where(lit[..., None], pts, -inf).amax(2)
        n, m = int(n_tri[0]), int(n_sph[0])
        assert n + m > 32  # the lists B1 culls
        rows_t = tri_sh[0, li * tri_stride : li * tri_stride + n]
        rows_s = sph_sh[0, li * sph_stride : li * sph_stride + m]
        base = fwd._P_LIGHTS + li * fwd._LIGHT_STRIDE
        o0 = torch.stack(k["o0"])
        keep_t, keep_s = fwd_tiled._shadow_keep_plain(
            rows_t, rows_s, lo, hi, params[base : base + 3], o0)
        engaged = lit.any(-1)
        tally["rows"] += int(engaged.sum()) * (n + m)
        tally["kept"] += int((keep_t.sum(-1) + keep_s.sum(-1))[engaged].sum())
        # the walk over the kept rows alone, pixel by pixel (lit pixels only)
        rd, ld = tuple(_patches(v) for v in k["rd"]), tuple(_patches(v) for v in k["ld"])
        p = tuple(_patches(v) for v in k["p"])
        tp, dist = _patches(t), _patches(k["dist"])
        got = torch.zeros_like(lit)
        for j0 in range(0, n, 128):
            c = [v[None, None, None, :] for v in rows_t[j0 : j0 + 128].T]
            b = fwd_tiled._tri_blocked(
                c, projective=True, x=None, y=None, t=tp[..., None], o0=k["o0"],
                rd=tuple(v[..., None] for v in rd))
            got |= (b & keep_t[:, :, None, j0 : j0 + 128]).any(-1)
        c = [v[None, None, None, :] for v in rows_s.T]
        b = fwd_tiled._sph_blocked(c, p=tuple(v[..., None] for v in p),
                                   ld=tuple(v[..., None] for v in ld),
                                   dist=dist[..., None])
        got |= (b & keep_s[:, :, None, :]).any(-1)
        want = _patches(occ)
        assert torch.equal(got[lit], want[lit]), \
            f"{int((got != want)[lit].sum())} lit pixels change their shadow"
        tally["lit"] += int(lit.sum())
        tally["calls"] += 1
        return occ

    monkeypatch.setattr(fwd_tiled, "_shadow_occluded_plain", culled)
    fwd_tiled._tiled_kernel_plain(*args, **kw)
    assert tally["calls"] == n_lights and tally["lit"] > 0
    share = 100.0 * tally["kept"] / tally["rows"]
    assert 0.0 < share < 50.0, f"kept {share:.2f}% of the rows"
