"""Tiled hard forward frame: binning in torch, then a hand-written CUDA kernel.

Covers both camera families: shared-direction (legacy ortho, affine
coefficient tests) and shared-origin pinhole (projective coefficient tests,
see `_prep_projective_coefs`).

1. BINNING (torch on the scene's device): a primitive can only cover a
   64x128-pixel tile if its screen-space bbox overlaps the tile rect. A
   (tiles x prims) overlap matrix -> top-K compaction gives each tile a
   candidate list in ascending primitive index plus a candidate count. Shadow
   candidates are binned per (light, tile) with the segment-hull test. The
   camera-dependent intersection coefficients are gathered into per-tile
   tables every frame (`_gather_coefs`).
2. TRACE: `tiled_kernel` launches kernels/csrc/fwd_tiled.cu on CUDA tensors
   and runs `_tiled_kernel_plain`, the same function in vectorised torch, on
   CPU tensors. One output-format switch gives the packed int32 RGBA words
   or the float RGBA frame ("int" is the float frame truncated).
3. OVERFLOW: eagerly, `render_tiled_packed` re-bins with K doubled until
   every candidate fits (bounded by the primitive count), so the tiled kernel
   never sees a truncated list. The compiled frame, `_render_tiled_jit`,
   bins at fixed K caps with no host read and chooses between the tiled and
   the brute kernel (kernels/fwd.py) on the bins' overflow flag through
   `runtime.graph.cond`, the JAX package's `lax.cond` under `jit`: in a
   CUDA graph only the branch taken runs (runtime/graph.py).

Shadows: a point p is occluded by triangle T from point light L iff p lies
inside T's light frustum — behind T's plane and inside the three side planes
through L and each edge. The four planes per (light, triangle) are one
16-float table row. Sphere occluders keep the geometric segment test.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from opencl_ray_tracer_tpu_torch.camera import Camera
from opencl_ray_tracer_tpu_torch.config import RenderConfig
from opencl_ray_tracer_tpu_torch.kernels.fwd import (
    _render_pallas_jit,
    _LIGHT_STRIDE,
    _P_AMBIENT,
    _P_D0,
    _P_DDX,
    _P_DDY,
    _P_LIGHTS,
    _P_O0,
    _P_SHINE,
    _P_SPEC,
    _SHADING_CODES,
    _camera_params,
    _check,
    _check_run_if,
    _cross,
    _out_buffer,
    _prep_affine_coefs,
    _prep_scene_arrays,
    _select_branch,
)
from opencl_ray_tracer_tpu_torch.ops.intersect import EPSILON, MISS_T
from opencl_ray_tracer_tpu_torch.ops.shading import (
    ALPHA_BITS,
    LEGACY_FOG_MAX,
    pack_framebuffer_words,
)
from opencl_ray_tracer_tpu_torch.runtime.graph import cond, device_const
from opencl_ray_tracer_tpu_torch.utils import tracing
from opencl_ray_tracer_tpu_torch.utils.log import log_warning

TILE_H = 64
TILE_W = 128
TILE_PIX = TILE_H * TILE_W       # 8192
CHUNK = 8                        # candidate-list granularity (K rounding)

# Shadow epsilons: the oracle offsets the shadow origin 1e-2 along the
# normal and requires t > 1e-3. The frustum test's equivalent is a distance
# margin on the (normalised) occluder-plane test; side planes use exact >= 0.
_SH_PLANE_EPS = 1e-2

# Elements per temporary of the plain twin (tile batch x chunk x pixels):
# 64 MB of float32, small on the card, a few at a time on the CPU.
_PLAIN_MAX_ELEMS = 1 << 24

_FORMAT_CODES = {"packed": 0, "float": 1}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

def _prim_bboxes(packed):
    """Screen-space (x0, x1, y0, y1) per triangle / sphere (ortho camera)."""
    v0 = packed.tri_v0  # (3, Tp)
    v1 = packed.tri_v0 + packed.tri_e1
    v2 = packed.tri_v0 + packed.tri_e2
    txs = torch.stack([v0[0], v1[0], v2[0]])
    tys = torch.stack([v0[1], v1[1], v2[1]])
    tri_box = (
        txs.amin(0) - 1e-3, txs.amax(0) + 1e-3,
        tys.amin(0) - 1e-3, tys.amax(0) + 1e-3,
    )
    c = packed.sph_origin  # (3, Sp)
    r = packed.sph_radius[0] + 1e-3
    sph_box = (c[0] - r, c[0] + r, c[1] - r, c[1] + r)
    return tri_box, sph_box


def _prim_z_extents(packed, pad):
    """World-z AABB extents (z0, z1) per triangle / sphere, padded — the
    occluder z inputs of the segment-hull shadow culling."""
    v0 = packed.tri_v0
    v1 = packed.tri_v0 + packed.tri_e1
    v2 = packed.tri_v0 + packed.tri_e2
    tzs = torch.stack([v0[2], v1[2], v2[2]])
    tri_z = (tzs.amin(0) - pad, tzs.amax(0) + pad)
    r = packed.sph_radius[0] + pad
    sph_z = (packed.sph_origin[2] - r, packed.sph_origin[2] + r)
    return tri_z, sph_z


def _tile_hit_z(t_idx, t_valid, s_idx, s_valid, tri_zext, sph_zext,
                nty, ntx):
    """Per-tile z range that hit points can occupy: the min/max of the
    (padded) z extents over the tile's primary candidates. Tiles with no
    primary candidates get an inverted slab; their shadow lists are never
    read (the kernel skips primary-empty tiles). Returns (tz0, tz1) shaped
    (nty, ntx, 1) for _bin_prims broadcasting."""
    big = 1e30

    def rng(idx, valid, zext):
        z0 = torch.where(valid, zext[0][idx], torch.full_like(zext[0][idx], big))
        z1 = torch.where(valid, zext[1][idx], torch.full_like(zext[1][idx], -big))
        return z0.amin(1), z1.amax(1)

    t0, t1 = rng(t_idx, t_valid, tri_zext)
    s0, s1 = rng(s_idx, s_valid, sph_zext)
    tz0 = torch.minimum(t0, s0).reshape(nty, ntx, 1)
    tz1 = torch.maximum(t1, s1).reshape(nty, ntx, 1)
    return tz0, tz1


def _pinhole_bboxes(packed, camera: Camera):
    """Screen-space conservative bboxes under a shared-origin pinhole camera.

    A world point P projects to [x*k, y*k, k] = M^-1 (P - o) with
    M = [ddx | ddy | d0] columns. A convex primitive's screen bbox is the
    bbox of its projected corner points; any corner at or behind the near
    plane makes the bbox cover the whole screen (uncullable, still right).
    Needs full-precision float32 matmuls (TF32 off) to match the JAX
    package's bins. (`inv_ex`: `inv`'s result without its check for a
    singular matrix, which reads a flag on the host.)
    """
    M = torch.stack([camera.ddx, camera.ddy, camera.d0], dim=1)
    Minv = torch.linalg.inv_ex(M)[0]
    big = 1e9

    def box(P):  # (N, K, 3) corner points per primitive
        v = torch.einsum("ij,nkj->nki", Minv, P - camera.o0)
        w = v[..., 2]
        front = w > 1e-6
        ok = torch.all(front, dim=1)
        sw = torch.where(front, w, torch.ones_like(w))
        sx = v[..., 0] / sw
        sy = v[..., 1] / sw
        pad = 1.0  # half-pixel centre offset + f32 slack
        neg = torch.full_like(ok, -big, dtype=torch.float32)
        pos = torch.full_like(ok, big, dtype=torch.float32)
        return (
            torch.where(ok, sx.amin(1) - pad, neg),
            torch.where(ok, sx.amax(1) + pad, pos),
            torch.where(ok, sy.amin(1) - pad, neg),
            torch.where(ok, sy.amax(1) + pad, pos),
        )

    v0 = packed.tri_v0.T  # (Tp, 3)
    tri_box = box(
        torch.stack([v0, v0 + packed.tri_e1.T, v0 + packed.tri_e2.T], dim=1)
    )
    c = packed.sph_origin.T  # (Sp, 3)
    r = packed.sph_radius[0]
    signs = device_const(_AABB_SIGNS, c.device)  # (8, 3) AABB corner pattern
    sph_box = box(c[:, None, :] + r[:, None, None] * signs[None])
    return tri_box, sph_box


_AABB_SIGNS = np.array([[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
                        for sz in (-1.0, 1.0)], np.float32)


def _prep_projective_coefs(packed, camera: Camera):
    """Per-primitive projective coefficients for shared-ORIGIN (pinhole)
    cameras. With origin o fixed and unnormalised direction
    d(x, y) = d0 + x*ddx + y*ddy, Möller–Trumbore is projective in pixel
    coords: det, u_num and v_num are affine in (x, y), t_num is constant;
    u = u_num/det, v = v_num/det and t = (t_num/det) * |d|. Sphere:
    L = c - o is constant, tca = (L . d)/|d|, d^2 = |L|^2 - tca^2.

    Returns tri_coef (10, Tp) rows [det0,detx,dety, un0,unx,uny,
    vn0,vnx,vny, tnum]; sph_coef (5, Sp) rows [tc0,tcx,tcy, L2, r2].
    Zero-padded triangles give det == 0 and fail |det| >= eps*|d|.
    """
    o0, d0, ddx, ddy = camera.o0, camera.d0, camera.ddx, camera.ddy

    v0 = packed.tri_v0.T  # (Tp, 3)
    e1 = packed.tri_e1.T
    e2 = packed.tri_e2.T
    pv0 = _cross(d0, e2)
    pvx = _cross(ddx, e2)
    pvy = _cross(ddy, e2)
    det0 = torch.sum(e1 * pv0, -1)
    detx = torch.sum(e1 * pvx, -1)
    dety = torch.sum(e1 * pvy, -1)
    base = o0 - v0
    un0 = torch.sum(base * pv0, -1)
    unx = torch.sum(base * pvx, -1)
    uny = torch.sum(base * pvy, -1)
    q = _cross(base, e1)
    vn0 = torch.sum(d0 * q, -1)
    vnx = torch.sum(ddx * q, -1)
    vny = torch.sum(ddy * q, -1)
    tnum = torch.sum(e2 * q, -1)
    tri_coef = torch.stack(
        [det0, detx, dety, un0, unx, uny, vn0, vnx, vny, tnum], 0
    )

    C = packed.sph_origin.T  # (Sp, 3)
    r = packed.sph_radius[0]
    L = C - o0
    tc0 = torch.sum(L * d0, -1)
    tcx = torch.sum(L * ddx, -1)
    tcy = torch.sum(L * ddy, -1)
    l2 = torch.sum(L * L, -1)
    sph_coef = torch.stack([tc0, tcx, tcy, l2, r * r], 0)
    return tri_coef, sph_coef


def _axis_s_interval(b0, b1, L, o0, o1):
    """Feasible s-interval for one axis of the segment-hull test.

    Points reachable by shadow segments are (1-s)*p + s*L, p in the tile's
    hit box B, s in [0, 1]. Per axis, the occluder interval [o0, o1] is
    reachable iff (1-s)*b0 + s*L <= o1 AND (1-s)*b1 + s*L >= o0. Returns
    (lo, hi, ok): feasible s in [lo, hi] when ok."""
    eps = 1e-12
    big = 1e30
    dA = L - b0
    rA = o1 - b0
    one = torch.ones_like(dA)
    hiA = torch.where(dA > eps, rA / torch.where(dA > eps, dA, one), big)
    loA = torch.where(dA < -eps, rA / torch.where(dA < -eps, dA, one), -big)
    okA = torch.where(torch.abs(dA) <= eps, rA >= 0, True)
    dB = L - b1
    rB = o0 - b1
    one = torch.ones_like(dB)
    loB = torch.where(dB > eps, rB / torch.where(dB > eps, dB, one), -big)
    hiB = torch.where(dB < -eps, rB / torch.where(dB < -eps, dB, one), big)
    okB = torch.where(torch.abs(dB) <= eps, rB <= 0, True)
    return torch.maximum(loA, loB), torch.minimum(hiA, hiB), okA & okB


def _bin_prims(box, n_real, nty, ntx, k, light_xy=None, offs=None,
               light_z=None, prim_z=None, tile_z=None):
    """(tiles x prims) overlap -> per-tile top-k candidate indices.

    With light_xy=(lx, ly) alone, tiles expand to the bbox of the
    tile->light corridor. With light_z + prim_z + tile_z too, the corridor
    tightens to the segment-hull test: the occluder AABB must intersect the
    convex hull of (tile hit box x light point). offs=(x_off, y_off) shifts
    the tile rects into world coordinates for shifted ortho cameras.

    Returns idx (n_tiles, k) int32 in ascending primitive order, valid
    (n_tiles, k) bool, count (n_tiles,) int32 (clamped to k), overflow ()."""
    x0, x1, y0, y1 = box
    p = x0.shape[0]
    dev = x0.device
    x_off, y_off = offs if offs is not None else (0.0, 0.0)
    tx0 = (torch.arange(ntx, dtype=torch.float32, device=dev) * TILE_W)[
        None, :, None] + x_off
    ty0 = (torch.arange(nty, dtype=torch.float32, device=dev) * TILE_H)[
        :, None, None] + y_off
    tx1 = tx0 + TILE_W
    ty1 = ty0 + TILE_H
    real = torch.arange(p, device=dev) < n_real
    if light_xy is not None and light_z is not None and tile_z is not None:
        lx, ly = light_xy
        pz0, pz1 = prim_z
        tz0, tz1 = tile_z
        sx0, sx1, okx = _axis_s_interval(tx0, tx1, lx, x0[None, None, :],
                                         x1[None, None, :])
        sy0, sy1, oky = _axis_s_interval(ty0, ty1, ly, y0[None, None, :],
                                         y1[None, None, :])
        sz0, sz1, okz = _axis_s_interval(tz0, tz1, light_z,
                                         pz0[None, None, :], pz1[None, None, :])
        lo = torch.maximum(torch.maximum(sx0, sy0), torch.clamp(sz0, min=0.0))
        hi = torch.minimum(torch.minimum(sx1, sy1), torch.clamp(sz1, max=1.0))
        overlap = (lo <= hi) & okx & oky & okz & real[None, None, :]
    else:
        if light_xy is not None:
            lx, ly = light_xy
            tx0 = torch.minimum(tx0, lx)
            tx1 = torch.maximum(tx1, lx)
            ty0 = torch.minimum(ty0, ly)
            ty1 = torch.maximum(ty1, ly)
        overlap = (
            (x0[None, None, :] <= tx1)
            & (x1[None, None, :] >= tx0)
            & (y0[None, None, :] <= ty1)
            & (y1[None, None, :] >= ty0)
            & real[None, None, :]
        )
    overlap = overlap.expand(nty, ntx, p).reshape(nty * ntx, p)
    counts = overlap.sum(dim=1, dtype=torch.int32)
    overflow = counts.max() > k
    # top-k by (overlap, ascending index): score = P - i for overlapping.
    # The scores of overlapping prims are unique, so the order is exact.
    # k may exceed the padded primitive count; the tail pads invalid.
    ktop = min(k, p)
    score = torch.where(
        overlap, p - torch.arange(p, dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
    )
    top, _ = torch.topk(score, ktop, dim=1)      # (n_tiles, ktop), descending
    valid = top > 0
    idx = torch.where(valid, p - top, torch.zeros_like(top)).to(torch.int32)
    if ktop < k:
        idx = torch.nn.functional.pad(idx, (0, k - ktop))
        valid = torch.nn.functional.pad(valid, (0, k - ktop))
    return idx, valid, torch.clamp(counts, max=k), overflow


# null coefficient rows: guarantee "never valid" in the kernel tests.
_NULL_TRI = np.array([-1e9, 0, 0, -1e9, 0, 0, 0, 0, 0], np.float32)
_NULL_SPH = np.array([-1e9, 0, 0, 1e9, 0, 0, 0, 0, 0, -1.0], np.float32)
# projective nulls: det == 0 fails |det| >= eps*|d|; tca < 0 fails tca >= 0.
_NULL_TRI_PROJ = np.zeros((10,), np.float32)
_NULL_SPH_PROJ = np.array([-1e9, 0, 0, 0, -1.0], np.float32)
# null shadow rows: tri planes all fail (c = -1e9); spheres at z=+1e9, r2=0.
_NULL_SH_TRI = np.array(
    [0, 0, 0, -1e9, 0, 0, 0, -1e9, 0, 0, 0, -1e9, 0, 0, 0, -1e9], np.float32
)
_NULL_SH_SPH = np.array(
    [0, 0, 1e9, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.float32
)


def _tri_shadow_planes(packed, lpos):
    """Light-frustum planes per triangle for point light `lpos` (3,).

    Row layout (16 floats): [m0(3) c0  m1(3) c1  m2(3) c2  n(3) cp] where a
    point p is occluded iff mi.p + ci >= 0 for the three (normalised) side
    planes and n.p + cp >= eps for the (normalised) triangle plane oriented
    away from the light. Degenerate rows are disabled via c = -1e9."""
    v0 = packed.tri_v0.T            # (Tp, 3)
    e1 = packed.tri_e1.T
    e2 = packed.tri_e2.T
    v1 = v0 + e1
    v2 = v0 + e2
    L = lpos[None, :]

    def _norm_rows(m):
        n = torch.linalg.vector_norm(m, dim=-1, keepdim=True)
        return m / torch.clamp(n, min=1e-20), n[..., 0]

    def side(vi, vj, vk):
        m = _cross(vj - vi, L - vi)
        m, mag = _norm_rows(m)
        s_k = torch.sum(m * (vk - vi), -1)
        m = m * torch.where(s_k < 0, -1.0, 1.0)[:, None]
        c = -torch.sum(m * vi, -1)
        degen = (torch.abs(s_k) < 1e-9) | (mag < 1e-12)
        c = torch.where(degen, -1e9, c)
        return m, c

    m0, c0 = side(v0, v1, v2)
    m1, c1 = side(v1, v2, v0)
    m2, c2 = side(v2, v0, v1)
    n = _cross(e1, e2)
    n, nmag = _norm_rows(n)
    s_l = torch.sum(n * (L - v0), -1)
    n = n * torch.where(s_l > 0, -1.0, 1.0)[:, None]
    cp = -torch.sum(n * v0, -1)
    degen = (torch.abs(s_l) < 1e-9) | (nmag < 1e-12)
    cp = torch.where(degen, -1e9, cp)
    return torch.cat(
        [m0, c0[:, None], m1, c1[:, None], m2, c2[:, None], n, cp[:, None]],
        dim=1,
    )  # (Tp, 16)


def _sph_shadow_rows(packed):
    """Sphere occluder rows: [cx, cy, cz, r2, 0...] (padded: r2=0, far z)."""
    sp = packed.padded_spheres
    zeros = torch.zeros((sp, 12), dtype=torch.float32, device=packed.device)
    return torch.cat(
        [packed.sph_origin.T, (packed.sph_radius[0] ** 2)[:, None], zeros],
        dim=1,
    )


def _shadow_tables(rows_per_light, box, n_real, nty, ntx, k, lights_pos,
                   null_row, offs=None, prim_z=None, tile_z=None):
    """Per-(light, tile) shadow-candidate tables, (n_tiles, L*k, 16): light
    li owns candidate rows [li*k, (li+1)*k).

    Returns (tables, counts (n_tiles, L) int32, overflow)."""
    tabs, cnts = [], []
    overflow = torch.zeros((), dtype=torch.bool, device=lights_pos.device)
    null_row = device_const(null_row, lights_pos.device)
    for li in range(lights_pos.shape[0]):
        idx, valid, count, over = _bin_prims(
            box, n_real, nty, ntx, k,
            light_xy=(lights_pos[li, 0], lights_pos[li, 1]), offs=offs,
            light_z=lights_pos[li, 2], prim_z=prim_z, tile_z=tile_z,
        )
        g = rows_per_light(li)[idx]                    # (n_tiles, k, 16)
        g = torch.where(valid[..., None], g, null_row)
        tabs.append(g)
        cnts.append(count)
        overflow = overflow | over
    return torch.cat(tabs, dim=1), torch.stack(cnts, dim=1), overflow


# ---------------------------------------------------------------------------
# Binning products
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TileBins:
    """Binning products (tensors on the scene's device) + static sizes.

    Ortho bins depend only on the scene (and the camera's origin offset);
    pinhole bins depend on the full camera pose. Compute once with
    `bin_scene` and pass to `render_tiled_packed` for a fixed scene."""

    t_idx: torch.Tensor       # (n_tiles, k_tri) int32
    t_valid: torch.Tensor     # (n_tiles, k_tri) bool
    s_idx: torch.Tensor       # (n_tiles, k_sph)
    s_valid: torch.Tensor
    tri_attr_t: torch.Tensor  # (n_tiles, k_tri, 8)
    sph_attr_t: torch.Tensor  # (n_tiles, k_sph, 8)
    tri_sh_t: torch.Tensor    # (n_tiles | 1, L*k_sh_tri, 16) frustum planes
    sph_sh_t: torch.Tensor    # (n_tiles | 1, L*k_sh_sph, 16) occluder rows
    counts: torch.Tensor      # (n_tiles, 2 + 2L) int32
    overflow: torch.Tensor    # () bool
    k_tri: int = 0
    k_sph: int = 0
    k_sh_tri: int = 0
    k_sh_sph: int = 0
    nty: int = 0
    ntx: int = 0
    projective: bool = False


def bin_scene(packed, *, height: int, width: int, k: int = 32,
              shadows: bool = False, shadow_k: int = 64,
              camera: Optional[Camera] = None) -> TileBins:
    """Tile binning (primary + shadow candidate lists).

    Without `camera` (or with a shared-direction one): ortho binning; a
    shared-direction camera contributes its origin offset o0.xy. With a
    normalize (pinhole) `camera`: perspective screen-space bboxes, and the
    shadow candidates of every tile are the full primitive set, stored once
    and shared by all tiles."""
    projective = camera is not None and camera.normalize
    offs = (
        (camera.o0[0], camera.o0[1])
        if (camera is not None and not projective) else None
    )
    dev = packed.device
    nty = _round_up(height, TILE_H) // TILE_H
    ntx = _round_up(width, TILE_W) // TILE_W
    n_tiles = nty * ntx
    n_lights = packed.lights.position.shape[0]
    _, tri_attr, _, sph_attr = _prep_scene_arrays(packed)
    if projective:
        tri_box, sph_box = _pinhole_bboxes(packed, camera)
    else:
        tri_box, sph_box = _prim_bboxes(packed)

    k_tri = min(k, _round_up(packed.n_tris, CHUNK)) if packed.n_tris else 0
    k_sph = min(k, _round_up(packed.n_spheres, CHUNK)) if packed.n_spheres else 0

    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    zero_cnt = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)

    def empty_lists():
        return (
            torch.zeros((n_tiles, CHUNK), dtype=torch.int32, device=dev),
            torch.zeros((n_tiles, CHUNK), dtype=torch.bool, device=dev),
            torch.zeros((n_tiles, CHUNK, 8), dtype=torch.float32, device=dev),
        )

    if k_tri:
        t_idx, t_valid, cnt_tri, over = _bin_prims(
            tri_box, packed.n_tris, nty, ntx, k_tri, offs=offs
        )
        overflow = overflow | over
        tri_attr_t = torch.where(t_valid[..., None], tri_attr[t_idx], 0.0)
    else:
        t_idx, t_valid, tri_attr_t = empty_lists()
        cnt_tri = zero_cnt
    if k_sph:
        s_idx, s_valid, cnt_sph, over = _bin_prims(
            sph_box, packed.n_spheres, nty, ntx, k_sph, offs=offs
        )
        overflow = overflow | over
        sph_attr_t = torch.where(s_valid[..., None], sph_attr[s_idx], 0.0)
    else:
        s_idx, s_valid, sph_attr_t = empty_lists()
        cnt_sph = zero_cnt

    sh_tiles = 1 if projective else n_tiles
    if projective:
        k_sh_tri = packed.padded_tris if (shadows and packed.n_tris) else 0
        k_sh_sph = packed.padded_spheres if (shadows and packed.n_spheres) else 0
    else:
        k_sh_tri = (
            min(shadow_k, _round_up(packed.n_tris, CHUNK))
            if (shadows and packed.n_tris) else 0
        )
        k_sh_sph = (
            min(shadow_k, _round_up(packed.n_spheres, CHUNK))
            if (shadows and packed.n_spheres) else 0
        )
    lpos = packed.lights.position
    # z inputs of the segment-hull shadow culling (small pad: exact hard
    # occlusion plus the shadow-ray t_min offset margin); tile_z is the
    # per-tile hit-z slab from the primary candidate lists.
    z_pad = 0.1
    tri_zext, sph_zext = _prim_z_extents(packed, z_pad)
    tile_z = _tile_hit_z(
        t_idx, t_valid, s_idx, s_valid, tri_zext, sph_zext, nty, ntx
    )
    zero_sh = torch.zeros((n_tiles, n_lights), dtype=torch.int32, device=dev)
    if k_sh_tri:
        if projective:
            planes = torch.stack(
                [_tri_shadow_planes(packed, lpos[li]) for li in range(n_lights)]
            )  # (L, Tp, 16); padded tris have degenerate rows (c = -1e9)
            tri_sh_t = planes.reshape(1, n_lights * k_sh_tri, 16)
            cnt_sh_tri = torch.full_like(zero_sh, packed.n_tris)
        else:
            tri_sh_t, cnt_sh_tri, over = _shadow_tables(
                lambda li: _tri_shadow_planes(packed, lpos[li]),
                tri_box, packed.n_tris, nty, ntx, k_sh_tri, lpos, _NULL_SH_TRI,
                offs=offs, prim_z=tri_zext, tile_z=tile_z,
            )
            overflow = overflow | over
    else:
        tri_sh_t = device_const(_NULL_SH_TRI, dev).expand(
            sh_tiles, n_lights * CHUNK, 16).contiguous()
        cnt_sh_tri = zero_sh
    if k_sh_sph:
        sph_rows = _sph_shadow_rows(packed)
        if projective:
            # null the padded slots (zero-radius spheres at the origin could
            # false-occlude a ray passing exactly through it)
            real = torch.arange(packed.padded_spheres, device=dev) < packed.n_spheres
            sph_rows = torch.where(real[:, None], sph_rows,
                                   device_const(_NULL_SH_SPH, dev))
            sph_sh_t = sph_rows.expand(n_lights, k_sh_sph, 16).reshape(
                1, n_lights * k_sh_sph, 16)
            cnt_sh_sph = torch.full_like(zero_sh, packed.n_spheres)
        else:
            sph_sh_t, cnt_sh_sph, over = _shadow_tables(
                lambda li: sph_rows,
                sph_box, packed.n_spheres, nty, ntx, k_sh_sph, lpos,
                _NULL_SH_SPH, offs=offs, prim_z=sph_zext, tile_z=tile_z,
            )
            overflow = overflow | over
    else:
        sph_sh_t = device_const(_NULL_SH_SPH, dev).expand(
            sh_tiles, n_lights * CHUNK, 16).contiguous()
        cnt_sh_sph = zero_sh

    # counts layout: [tri, sph, (sh_tri, sh_sph) per light]
    sh_cols = torch.stack([cnt_sh_tri, cnt_sh_sph], dim=-1).reshape(
        n_tiles, 2 * n_lights
    )
    counts = torch.cat(
        [cnt_tri[:, None], cnt_sph[:, None], sh_cols], dim=1
    ).to(torch.int32)

    return TileBins(
        t_idx=t_idx, t_valid=t_valid, s_idx=s_idx, s_valid=s_valid,
        tri_attr_t=tri_attr_t, sph_attr_t=sph_attr_t,
        tri_sh_t=tri_sh_t, sph_sh_t=sph_sh_t, counts=counts,
        overflow=overflow,
        k_tri=k_tri, k_sph=k_sph, k_sh_tri=k_sh_tri, k_sh_sph=k_sh_sph,
        nty=nty, ntx=ntx, projective=projective,
    )


def _gather_coefs(coef, idx, valid, null_col):
    """Camera-dependent per-frame gather: coef (C, P) -> (n_tiles, k, 16)."""
    c = coef.shape[0]
    g = coef.T[idx]
    g = torch.where(valid[..., None], g, device_const(null_col[:c], coef.device))
    return torch.nn.functional.pad(g, (0, 16 - c))


# ---------------------------------------------------------------------------
# The kernel: plain twin + CUDA wrapper
# ---------------------------------------------------------------------------

def _tiled_kernel_plain(params, counts, tri_coef_t, tri_attr_t, sph_coef_t,
                        sph_attr_t, tri_sh_t, sph_sh_t, *, height, width,
                        ntx, shading, shadows, projective, out_format):
    """The tiled kernel as vectorised torch over (tile, pixel, candidate).

    Same inputs and outputs as `tiled_kernel`, and the same arithmetic in
    the same order: tiles are processed in batches and candidates in chunks
    of a running nearest-hit (strict <, the first minimal index wins), so
    memory stays bounded by `_PLAIN_MAX_ELEMS` elements per temporary.
    Reciprocal square roots are 1 / sqrt, as in the kernel: `torch.rsqrt`
    differs from it in the last bit (on the CPU for 0.5% of inputs, on a CUDA
    card by up to two), which flips edge and shadow pixels of a pinhole
    frame. Returns (height, width) int32 words for out_format "packed", else
    (height, width, 4) float32."""
    dev = params.device
    n_tiles = counts.shape[0]
    nty = n_tiles // ntx
    n_lights = (params.shape[0] - _P_LIGHTS) // _LIGHT_STRIDE
    sh_tri_stride = tri_sh_t.shape[1] // n_lights
    sh_sph_stride = sph_sh_t.shape[1] // n_lights
    prm = [params[i] for i in range(params.shape[0])]
    d0x, d0y, d0z = prm[_P_D0 : _P_D0 + 3]
    o0x, o0y, o0z = prm[_P_O0 : _P_O0 + 3]
    ddxv = prm[_P_DDX : _P_DDX + 3]
    ddyv = prm[_P_DDY : _P_DDY + 3]
    packed_out = out_format == "packed"

    if packed_out:
        out_t = torch.full((n_tiles, TILE_PIX), ALPHA_BITS, dtype=torch.int32,
                           device=dev)
    else:
        out_t = torch.zeros((n_tiles, TILE_PIX, 4), dtype=torch.float32,
                            device=dev)
        out_t[..., 3] = 255.0
    lane = torch.arange(TILE_PIX, device=dev)
    lx_pix = (lane % TILE_W).to(torch.float32)
    lrow = (lane // TILE_W).to(torch.float32)
    nonempty = torch.nonzero((counts[:, 0] + counts[:, 1]) > 0).flatten()
    ch = 64                                   # candidates per chunk
    nb = max(1, _PLAIN_MAX_ELEMS // (TILE_PIX * ch))  # tiles per batch

    def cols(rows):
        return [rows[:, :, q : q + 1] for q in range(rows.shape[2])]

    # (split gives one empty batch for an empty list: a frame with no candidate)
    for tb in nonempty.split(nb) if nonempty.numel() else ():
        cnt = counts[tb]
        ty = tb // ntx
        tx = tb - ty * ntx
        x = ((tx * TILE_W).to(torch.float32)[:, None] + lx_pix)[:, None, :]
        y = ((ty * TILE_H).to(torch.float32)[:, None] + lrow)[:, None, :]

        if projective:
            dux = d0x + x * ddxv[0] + y * ddyv[0]
            duy = d0y + x * ddxv[1] + y * ddyv[1]
            duz = d0z + x * ddxv[2] + y * ddyv[2]
            len2 = torch.clamp(dux * dux + duy * duy + duz * duz, min=1e-20)
            inv_len = 1.0 / torch.sqrt(len2)
            len_d = len2 * inv_len

            def tri_test(c):
                det = c[0] + x * c[1] + y * c[2]
                un = c[3] + x * c[4] + y * c[5]
                vn = c[6] + x * c[7] + y * c[8]
                sgn = torch.where(det >= 0.0, 1.0, -1.0)
                dets = det * sgn
                uns = un * sgn
                vns = vn * sgn
                valid = ((dets >= EPSILON * len_d) & (uns >= 0.0)
                         & (vns >= 0.0) & (uns + vns <= dets))
                t = c[9] / torch.where(valid, det, torch.ones_like(det)) * len_d
                return t, valid

            def sph_test(c):
                tca = (c[0] + x * c[1] + y * c[2]) * inv_len
                d2 = c[3] - tca * tca
                hit = (tca >= 0.0) & (d2 <= c[4])
                t0 = tca - torch.sqrt(torch.clamp(c[4] - d2, min=0.0))
                return t0, hit & (t0 != 0.0)
        else:
            x2, y2, xy = x * x, y * y, x * y

            def tri_test(c):
                u = c[0] + x * c[1] + y * c[2]
                v = c[3] + x * c[4] + y * c[5]
                t = c[6] + x * c[7] + y * c[8]
                valid = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
                return t, valid

            def sph_test(c):
                tca = c[0] + x * c[1] + y * c[2]
                d2 = (c[3] + x * c[4] + y * c[5] + x2 * c[6] + y2 * c[7]
                      + xy * c[8])
                hit = (tca >= 0.0) & (d2 <= c[9])
                t0 = tca - torch.sqrt(torch.clamp(c[9] - d2, min=0.0))
                return t0, hit & (t0 != 0.0)

        best_t = torch.full((tb.shape[0], TILE_PIX), MISS_T,
                            dtype=torch.float32, device=dev)
        best_idx = torch.zeros_like(best_t, dtype=torch.int64)
        best_sph = torch.zeros_like(best_t, dtype=torch.bool)
        for table, n, test, is_sph in (
            (tri_coef_t, cnt[:, 0], tri_test, False),
            (sph_coef_t, cnt[:, 1], sph_test, True),
        ):
            for c0 in range(0, int(n.max()), ch):
                rows = table[tb, c0 : c0 + ch]
                t, valid = test(cols(rows))
                j = torch.arange(c0, c0 + rows.shape[1], device=dev)
                valid = valid & (j[None, :, None] < n[:, None, None])
                tpair = torch.where(valid, t, MISS_T)
                cmin, first = tpair.min(dim=1)
                wins = cmin < best_t
                best_t = torch.where(wins, cmin, best_t)
                best_idx = torch.where(wins, first + c0, best_idx)
                best_sph = torch.where(wins, is_sph, best_sph)

        rows_b = torch.arange(tb.shape[0], device=dev)[:, None]
        attr = torch.where(
            best_sph[..., None],
            sph_attr_t[tb][rows_b, best_idx.clamp(max=sph_attr_t.shape[1] - 1)],
            tri_attr_t[tb][rows_b, best_idx.clamp(max=tri_attr_t.shape[1] - 1)],
        )
        hit = best_t < MISS_T
        attr = torch.where(hit[..., None], attr, 0.0)
        cr, cg, cb = attr[..., 0], attr[..., 1], attr[..., 2]
        t = best_t
        x, y = x[:, 0], y[:, 0]

        if shading == "legacy":
            scalar_t = 255.0 - t * (255.0 / LEGACY_FOG_MAX)
            r = torch.where(hit, cr * scalar_t, 0.0)
            g = torch.where(hit, cg * scalar_t, 0.0)
            b = torch.where(hit, cb * scalar_t, 0.0)
        else:
            if projective:
                rdx, rdy, rdz = (dux[:, 0] * inv_len[:, 0],
                                 duy[:, 0] * inv_len[:, 0],
                                 duz[:, 0] * inv_len[:, 0])
                px = o0x + t * rdx
                py = o0y + t * rdy
                pz = o0z + t * rdz
                vx, vy, vz = -rdx, -rdy, -rdz
            else:
                rdx, rdy, rdz = d0x, d0y, d0z
                px = o0x + x + t * d0x
                py = o0y + y + t * d0y
                pz = o0z + t * d0z
                vinv = 1.0 / torch.sqrt(
                    torch.clamp(d0x * d0x + d0y * d0y + d0z * d0z, min=1e-20))
                vx, vy, vz = -d0x * vinv, -d0y * vinv, -d0z * vinv
            ax, ay, az = attr[..., 3], attr[..., 4], attr[..., 5]
            irad, is_sph = attr[..., 6], attr[..., 7]
            nsx = (px - ax) * irad
            nsy = (py - ay) * irad
            nsz = (pz - az) * irad
            flip = torch.where(ax * rdx + ay * rdy + az * rdz > 0, -1.0, 1.0)
            sph_w = is_sph > 0.5
            nx = torch.where(sph_w, nsx, ax * flip)
            ny = torch.where(sph_w, nsy, ay * flip)
            nz = torch.where(sph_w, nsz, az * flip)
            ninv = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                                min=1e-20))
            nx, ny, nz = nx * ninv, ny * ninv, nz * ninv

            ambient, spec_k, shine = prm[_P_AMBIENT], prm[_P_SPEC], prm[_P_SHINE]
            zero = torch.zeros_like(t)
            diff_r, diff_g, diff_b = zero, zero, zero
            spec_r, spec_g, spec_b = zero, zero, zero
            for li in range(n_lights):
                base = _P_LIGHTS + li * _LIGHT_STRIDE
                lpx, lpy, lpz = prm[base : base + 3]
                lcr, lcg, lcb = prm[base + 3 : base + 6]
                lint = prm[base + 6]
                tlx, tly, tlz = lpx - px, lpy - py, lpz - pz
                tl2 = torch.clamp(tlx * tlx + tly * tly + tlz * tlz, min=1e-20)
                rinv = 1.0 / torch.sqrt(tl2)
                ldx, ldy, ldz = tlx * rinv, tly * rinv, tlz * rinv
                if shadows:
                    dist = tl2 * rinv
                    occ = _shadow_occluded_plain(
                        tri_sh_t[0:1] if projective else tri_sh_t[tb],
                        sph_sh_t[0:1] if projective else sph_sh_t[tb],
                        cnt[:, 2 + 2 * li], cnt[:, 3 + 2 * li],
                        li, sh_tri_stride, sh_sph_stride, ch,
                        projective=projective, x=x, y=y, t=t,
                        p=(px, py, pz), ld=(ldx, ldy, ldz), dist=dist,
                        o0=(o0x, o0y, o0z), rd=(rdx, rdy, rdz),
                    )
                    vis = torch.where(occ, 0.0, 1.0)
                else:
                    vis = 1.0
                ndl = nx * ldx + ny * ldy + nz * ldz
                ndotl = torch.clamp(ndl, min=0.0)
                wdiff = lint * ndotl * vis
                diff_r = diff_r + wdiff * lcr
                diff_g = diff_g + wdiff * lcg
                diff_b = diff_b + wdiff * lcb
                if shading == "phong":
                    two_ndl = 2.0 * ndl
                    rx = two_ndl * nx - ldx
                    ry = two_ndl * ny - ldy
                    rz = two_ndl * nz - ldz
                    rdotv = torch.clamp(rx * vx + ry * vy + rz * vz, min=0.0)
                    wspec = (
                        spec_k
                        * torch.exp(shine * torch.log(torch.clamp(rdotv,
                                                                  min=1e-20)))
                        * lint * vis * (ndotl > 0.0)
                    )
                    spec_r = spec_r + wspec * lcr
                    spec_g = spec_g + wspec * lcg
                    spec_b = spec_b + wspec * lcb
            r = torch.clamp(cr * (ambient + diff_r) + spec_r, 0.0, 1.0) * 255.0
            g = torch.clamp(cg * (ambient + diff_g) + spec_g, 0.0, 1.0) * 255.0
            b = torch.clamp(cb * (ambient + diff_b) + spec_b, 0.0, 1.0) * 255.0
            r = torch.where(hit, r, 0.0)
            g = torch.where(hit, g, 0.0)
            b = torch.where(hit, b, 0.0)

        if packed_out:
            ri = torch.clamp(r, 0.0, 255.0).to(torch.int32)
            gi = torch.clamp(g, 0.0, 255.0).to(torch.int32)
            bi = torch.clamp(b, 0.0, 255.0).to(torch.int32)
            out_t[tb] = ri + gi * 256 + bi * 65536 + ALPHA_BITS
        else:
            out_t[tb] = torch.stack([r, g, b, torch.full_like(r, 255.0)], -1)

    tail = out_t.shape[2:]
    img = out_t.reshape((nty, ntx, TILE_H, TILE_W) + tail)
    img = img.permute((0, 2, 1, 3) + tuple(range(4, img.dim()))).reshape(
        (nty * TILE_H, ntx * TILE_W) + tail
    )
    return img[:height, :width].contiguous()


def _shadow_occluded_plain(tri_sh, sph_sh, n_tri, n_sph, li, tri_stride,
                           sph_stride, ch, *, projective, x, y, t, p, ld, dist,
                           o0, rd):
    """Hard-shadow any-hit of the plain twin for light `li` over a batch of
    tiles: triangle frustum-plane tests, then sphere segment tests.

    tri_sh/sph_sh: the batch's shadow tables (nb or 1, L*stride, 16);
    n_tri/n_sph: (nb,) candidate counts; x, y, t, dist and the components of
    p, ld (and rd under a pinhole) are (nb, TP); rd is the ray direction (the
    shared d0 for ortho). Returns bool (nb, TP)."""
    occ = torch.zeros_like(t, dtype=torch.bool)
    x, y, t, dist = (v[:, None] for v in (x, y, t, dist))
    p, ld, rd = (tuple(v[:, None] if v.dim() else v for v in vec)
                 for vec in (p, ld, rd))
    o0x, o0y, o0z = o0

    def tri_blocked(c):
        blocked = None
        for pi in range(4):
            mx, my, mz, cc = c[4 * pi : 4 * pi + 4]
            md = mx * rd[0] + my * rd[1] + mz * rd[2]
            s = cc + mx * o0x + my * o0y + mz * o0z
            if not projective:
                s = s + mx * x + my * y
            cond = s + md * t >= (_SH_PLANE_EPS if pi == 3 else 0.0)
            blocked = cond if blocked is None else (blocked & cond)
        return blocked

    def sph_blocked(c):
        cx, cy, cz, r2 = c[0:4]
        lx, ly, lz = cx - p[0], cy - p[1], cz - p[2]
        tca = lx * ld[0] + ly * ld[1] + lz * ld[2]
        m2 = lx * lx + ly * ly + lz * lz - tca * tca
        hit = (tca >= 0.0) & (m2 <= r2)
        t0 = tca - torch.sqrt(torch.clamp(r2 - m2, min=0.0))
        return hit & (t0 > 1e-3) & (t0 < dist)

    for table, stride, n, blocked_fn in (
        (tri_sh, tri_stride, n_tri, tri_blocked),
        (sph_sh, sph_stride, n_sph, sph_blocked),
    ):
        for c0 in range(0, int(n.max()), ch):
            c1 = min(c0 + ch, stride)
            rows = table[:, li * stride + c0 : li * stride + c1]
            c = [rows[:, :, q : q + 1] for q in range(16)]
            j = torch.arange(c0, c1, device=t.device)
            blocked = blocked_fn(c) & (j[None, :, None] < n[:, None, None])
            occ = occ | blocked.any(dim=1)
    return occ


def tiled_kernel(params, counts, tri_coef_t, tri_attr_t, sph_coef_t,
                 sph_attr_t, tri_sh_t, sph_sh_t, *, height: int, width: int,
                 ntx: int, shading: str, shadows: bool, projective: bool,
                 out_format: str, run_if=None, want: int = 0):
    """The tiled hard forward kernel.

    CUDA tensors launch kernels/csrc/fwd_tiled.cu (built on first use) or
    raise; CPU tensors run `_tiled_kernel_plain`. `run_if` (one int32 on the
    device, or None) is the device-side branch of `lax.cond`: the kernel
    does its work only where *run_if == want, else its frame is zeros (the
    twin: a torch.where). Inputs: params (21+7L,)
    f32; counts (n_tiles, 2+2L) i32; tri/sph coefficient tables (n_tiles,
    k, 16) f32 and attribute tables (n_tiles, k, 8) f32; shadow tables
    (n_tiles or 1, L*k_sh, 16) f32. out_format "packed" gives (H, W) int32
    RGBA words, "float" gives (H, W, 4) float32."""
    args = (params, counts, tri_coef_t, tri_attr_t, sph_coef_t, sph_attr_t,
            tri_sh_t, sph_sh_t)
    kw = dict(height=height, width=width, ntx=ntx, shading=shading,
              shadows=shadows, projective=projective, out_format=out_format)
    dev = params.device
    if shading not in _SHADING_CODES or out_format not in _FORMAT_CODES:
        raise ValueError(f"bad shading {shading!r} / out_format {out_format!r}")
    _check_run_if(run_if, dev)
    if dev.type == "cpu":
        return _select_branch(_tiled_kernel_plain(*args, **kw), run_if, want)
    if dev.type != "cuda":
        raise ValueError(f"tiled_kernel runs on cuda or cpu tensors, got {dev}")

    n_tiles = counts.shape[0]
    nty = n_tiles // ntx
    n_lights = (params.shape[0] - _P_LIGHTS) // _LIGHT_STRIDE
    if n_lights < 1 or params.shape[0] != _P_LIGHTS + n_lights * _LIGHT_STRIDE:
        raise ValueError(f"params length {params.shape[0]} is not 21 + 7L")
    if nty * ntx != n_tiles or nty * TILE_H < height or ntx * TILE_W < width:
        raise ValueError("tile grid does not cover the frame")
    k_tri, k_sph = tri_coef_t.shape[1], sph_coef_t.shape[1]
    sh_tiles = 1 if projective else n_tiles
    _check("params", params, torch.float32, device=dev)
    _check("counts", counts, torch.int32, (n_tiles, 2 + 2 * n_lights), dev)
    _check("tri_coef_t", tri_coef_t, torch.float32, (n_tiles, k_tri, 16), dev)
    _check("tri_attr_t", tri_attr_t, torch.float32, (n_tiles, k_tri, 8), dev)
    _check("sph_coef_t", sph_coef_t, torch.float32, (n_tiles, k_sph, 16), dev)
    _check("sph_attr_t", sph_attr_t, torch.float32, (n_tiles, k_sph, 8), dev)
    _check("tri_sh_t", tri_sh_t, torch.float32, device=dev)
    _check("sph_sh_t", sph_sh_t, torch.float32, device=dev)
    for name, tab in (("tri_sh_t", tri_sh_t), ("sph_sh_t", sph_sh_t)):
        if tab.dim() != 3 or tab.shape[0] != sh_tiles or tab.shape[2] != 16 \
                or tab.shape[1] % n_lights:
            raise ValueError(f"{name}: bad shadow table shape {tuple(tab.shape)}")

    return _tiled_kernel_cuda(*args, **kw, run_if=run_if, want=want)[0]


def _live_tiles(counts):
    """The tiled forward kernels' list in its plain version: the tiles whose
    counts row holds a primary candidate (counts[:, 0] + counts[:, 1] > 0),
    ascending. The CUDA kernels (B1/B2, B4) build it on the card
    (kernels/csrc/tile_list.cuh) and launch blocks for nothing else."""
    return torch.nonzero((counts[:, 0] + counts[:, 1]) > 0)[:, 0]


def _tiled_kernel_cuda(params, counts, tri_coef_t, tri_attr_t, sph_coef_t,
                       sph_attr_t, tri_sh_t, sph_sh_t, *, height, width, ntx,
                       shading, shadows, projective, out_format, run_if=None,
                       want=0):
    """Launch B1/B2 on CUDA tensors (checked by `tiled_kernel`) -> (frame,
    tiles). `tiles` is the int32 list of non-empty tiles that the kernel's
    blocks build from `counts` (kernels/csrc/tile_list.cuh): tiles[0] their
    number, tiles[2 : 2 + tiles[0]] the tiles in ascending order
    (`_live_tiles` is its plain version), then the empty ones. With
    `run_if`, both start as zeros, which a skipped launch leaves."""
    from opencl_ray_tracer_tpu_torch.kernels._build import load_library

    lib = load_library()
    dev = params.device
    n_tiles = counts.shape[0]
    n_lights = (params.shape[0] - _P_LIGHTS) // _LIGHT_STRIDE
    if out_format == "packed":
        out = _out_buffer((height, width), torch.int32, dev, run_if)
    else:
        out = _out_buffer((height, width, 4), torch.float32, dev, run_if)
    tiles = _out_buffer((2 + n_tiles,), torch.int32, dev, run_if)
    p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.octrt_fwd_tiled(
            p(params), p(counts), p(tri_coef_t), p(tri_attr_t),
            p(sph_coef_t), p(sph_attr_t), p(tri_sh_t), p(sph_sh_t), p(out),
            p(tiles), height, width, ntx, n_tiles, tri_coef_t.shape[1],
            sph_coef_t.shape[1], tri_sh_t.shape[1] // n_lights,
            sph_sh_t.shape[1] // n_lights, n_lights, _SHADING_CODES[shading],
            int(bool(shadows)), int(bool(projective)), _FORMAT_CODES[out_format],
            p(run_if), int(want), ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(
            f"fwd_tiled kernel launch failed: {lib.octrt_cuda_error_string(rc).decode()}"
            f" (cudaError {rc})"
        )
    tracing.count("launch.B1")
    return out, tiles


# ---------------------------------------------------------------------------
# Frame entry points
# ---------------------------------------------------------------------------

def kernel_inputs(packed, camera: Camera, bins: TileBins, *, height: int,
                  width: int, shading: str, shadows: bool,
                  out_format: str = "int"):
    """Per-frame coefficient gather + params: the (args, kwargs) that
    `tiled_kernel` (and `_tiled_kernel_plain`) take for this frame. "int"
    frames use the kernel's float output, truncated afterwards. The span
    `frame.gather` (`utils.tracing`)."""
    with tracing.span("frame.gather"):
        projective = camera.normalize
        if bins.projective != projective:
            raise ValueError(
                "TileBins/camera mismatch: pinhole cameras need bins computed "
                "with bin_scene(..., camera=camera)"
            )
        n_tiles = bins.nty * bins.ntx
        dev = packed.device
        if projective:
            tri_coef, sph_coef = _prep_projective_coefs(packed, camera)
            null_tri, null_sph = _NULL_TRI_PROJ, _NULL_SPH_PROJ
        else:
            tri_coef, sph_coef = _prep_affine_coefs(packed, camera)
            null_tri, null_sph = _NULL_TRI, _NULL_SPH

        def table(k, coef, idx, valid, null):
            if k:
                return _gather_coefs(coef, idx, valid, null)
            row = device_const(np.pad(null, (0, 16 - null.shape[0])), dev)
            return row.expand(n_tiles, CHUNK, 16).contiguous()

        args = (
            _camera_params(camera, packed.lights).contiguous(),
            bins.counts.contiguous(),
            table(bins.k_tri, tri_coef, bins.t_idx, bins.t_valid, null_tri),
            bins.tri_attr_t.contiguous(),
            table(bins.k_sph, sph_coef, bins.s_idx, bins.s_valid, null_sph),
            bins.sph_attr_t.contiguous(),
            bins.tri_sh_t.contiguous(),
            bins.sph_sh_t.contiguous(),
        )
        kw = dict(height=height, width=width, ntx=bins.ntx, shading=shading,
                  shadows=shadows, projective=projective,
                  out_format="packed" if out_format == "packed" else "float")
        return args, kw


def bin_for_config(packed, camera: Camera, config: RenderConfig) -> TileBins:
    """`bin_scene` at the config's K caps, re-binning with both caps doubled
    while any tile overflows, up to the primitive count (where no list can
    overflow). The span `frame.bin` (`utils.tracing`)."""
    k, shadow_k = config.cull_k, config.shadow_cull_k

    def make(k_, sk_):
        return bin_scene(
            packed, height=config.height, width=config.width, k=k_,
            shadows=config.shadows, shadow_k=sk_, camera=camera,
        )

    with tracing.span("frame.bin"):
        bins = make(k, shadow_k)
        k_max = _round_up(max(packed.n_tris, packed.n_spheres, 1), CHUNK)
        while _overflow_on_host(bins):
            if k >= k_max and shadow_k >= k_max:
                raise RuntimeError("tile candidate overflow at the full K")
            k = max(k, min(2 * k, k_max))
            shadow_k = max(shadow_k, min(2 * shadow_k, k_max))
            log_warning(
                "tile candidate overflow: re-binning with cull_k=%d "
                "shadow_cull_k=%d", k, shadow_k,
            )
            bins = make(k, shadow_k)
        return bins


def _overflow_on_host(bins: TileBins) -> bool:
    """The bins' overflow flag read on the host, which waits for the card
    to finish the binning: the span `frame.bin.host_read`."""
    with tracing.span("frame.bin.host_read"):
        return bool(bins.overflow)


def render_tiled(scene, camera: Camera, config: RenderConfig) -> torch.Tensor:
    return render_tiled_packed(scene.pack(), camera, config)


def _frame_branches(packed, camera: Camera, bins: TileBins, *, height: int,
                    width: int, shading: str, shadows: bool, out_format: str):
    """(brute_render, tiled_render): the two branches of the compiled
    frame's cond, split as the JAX package's (fwd_tiled.py:1353-1500). The
    coefficient gather (`kernel_inputs`) runs here, before the cond;
    `tiled_render` launches B1/B2 on it, `brute_render` prepares B3's
    operands, launches B3 and for a packed frame packs its words, as
    `brute_render_packed` does. Each is fn(run_if=None) -> the frame in
    kernel_inputs' formats ((H, W) words or (H, W, 4) float); with `run_if`
    its kernel works only where the flag takes its branch."""
    args, kw = kernel_inputs(packed, camera, bins, height=height, width=width,
                             shading=shading, shadows=shadows,
                             out_format=out_format)

    def tiled_render(run_if=None):
        return tiled_kernel(*args, **kw, run_if=run_if, want=0)

    def brute_render(run_if=None):
        rgba = _render_pallas_jit(packed, camera, height=height, width=width,
                                  shading=shading, shadows=shadows,
                                  run_if=run_if, want=1)
        return pack_framebuffer_words(rgba) if out_format == "packed" else rgba

    return brute_render, tiled_render


@torch.no_grad()
def _render_tiled_jit(packed, camera: Camera, bins: TileBins, *, height: int,
                      width: int, shading: str, shadows: bool,
                      out_format: str = "int") -> torch.Tensor:
    """The tiled frame from given bins with no host read: the JAX package's
    `_render_tiled_jit` (fwd_tiled.py:1266-1505). The bins may overflow
    their K caps: `cond(bins.overflow, brute_render, tiled_render)` runs the
    brute kernel (B3) where they do and the tiled kernel (B1/B2) where they
    do not, chosen on the card as `lax.cond` chooses under `jit` (captured,
    a replay runs only the branch taken). Returns what
    `render_tiled_packed` returns for `out_format`."""
    img = cond(bins.overflow, *_frame_branches(
        packed, camera, bins, height=height, width=width, shading=shading,
        shadows=shadows, out_format=out_format))
    if out_format == "int":
        return torch.trunc(img).to(torch.int32)
    return img


def bin_fixed(packed, camera: Camera, config: RenderConfig) -> TileBins:
    """`bin_scene` at the config's K caps (no re-binning: the bins may
    overflow), the bins of the JAX package's `render_tiled_packed` under
    `jit`."""
    return bin_scene(packed, height=config.height, width=config.width,
                     k=config.cull_k, shadows=config.shadows,
                     shadow_k=config.shadow_cull_k, camera=camera)


def render_tiled_fixed(scene, camera: Camera, config: RenderConfig) -> torch.Tensor:
    """The whole tiled frame at fixed K caps with no host read (pack, bins,
    gather, B1/B2 or the brute fallback B3 chosen on the card): what the
    JAX package's `render_tiled` is under `jax.jit`, and what
    `runtime.graph.jit` captures. Takes a Scene or a PackedScene."""
    packed = scene.pack() if hasattr(scene, "pack") else scene
    return _render_tiled_jit(
        packed, camera, bin_fixed(packed, camera, config), height=config.height,
        width=config.width, shading=config.shading, shadows=config.shadows,
        out_format=config.framebuffer_dtype)


@torch.no_grad()
def render_tiled_packed(packed, camera: Camera, config: RenderConfig,
                        bins: Optional[TileBins] = None) -> torch.Tensor:
    """Tiled+culled render of a packed scene, for both camera families.

    Returns (H, W) int32 words for framebuffer_dtype "packed", else
    (H, W, 4) int32 ("int", truncated) or float32 ("float").

    Overflow policy: a tile exceeding cull_k / shadow_cull_k re-bins with
    both doubled, up to the primitive count, where no list can overflow.
    Precomputed `bins` must not overflow: this path has no brute fallback
    (the brute kernel is reached through kernels.render_pallas)."""
    if bins is None:
        bins = bin_for_config(packed, camera, config)
    elif bool(bins.overflow):
        raise ValueError("bins overflow their K; re-bin with a larger K")
    args, kw = kernel_inputs(
        packed, camera, bins, height=config.height, width=config.width,
        shading=config.shading, shadows=config.shadows,
        out_format=config.framebuffer_dtype,
    )
    out = tiled_kernel(*args, **kw)
    if config.framebuffer_dtype == "int":
        return torch.trunc(out).to(torch.int32)
    return out
