"""Tiled+culled soft differentiable renderer: binning and tables in torch,
then hand-written CUDA kernels for the forward (B4) and backward (B5).

1. BINNING (torch, no grad): primitive screen bboxes padded by
   SOFT_CULL_SIGMAS * tau_edge — beyond ~16 sigma the coverage sigmoids
   underflow to exact float32 zero, so culling changes neither the image nor
   the gradients. Shadow candidates use the segment-hull corridor of
   fwd_tiled._bin_prims with the same pad. Binning is at the config's K
   caps, as the JAX package always bins; where any tile's list overflows,
   the frame is the brute soft kernels' (kernels/soft.py), as under JAX's
   `lax.cond`. `render_soft_tiled` reads the overflow flag once and runs
   only that branch; `_soft_tiled_core` chooses on the card with no host
   read, its forward and its backward each a `runtime.graph.cond`, so that
   in a CUDA graph only the branch taken runs. `soft_bins_for_config` is an
   opt-in helper that re-bins with K doubled until no tile overflows (not
   the JAX package's semantics): what the smoke and the bench use to set a
   kernel's K outright.
2. TABLES (torch, differentiable): per-tile gathered coefficient rows
   (`_gather_soft_tables`). Autograd of the gather IS the scatter-add of the
   per-tile gradient tables back onto the scene, camera and lights.
3. KERNELS, behind one torch.autograd.Function (`SoftTiledFunction`): on
   CUDA tensors the forward launches kernels/csrc/soft_tiled.cu's forward
   and the backward its backward (which works only where the cotangent is
   non-zero: `_live_patches`); on CPU tensors both run `_soft_tiled_plain`,
   the same function in vectorised torch, whose autograd is the backward's
   plain version. Two regimes, chosen as the JAX package chooses them, by
   the bins' static slot count (`_use_stored_finals`): the backward
   recomputes each pixel's streaming finals, or (stored finals, from
   `_FINALS_MIN_SLOTS` slots on) the forward also writes them into a block
   (`finals_block`, `_finals_layout`) that the backward reads.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from opencl_ray_tracer_tpu_torch.camera import Camera
from opencl_ray_tracer_tpu_torch.config import RenderConfig
from opencl_ray_tracer_tpu_torch.diff.soft import (
    SHADOW_OFFSET,
    SHADOW_T_MIN,
    softplus,
    tclip,
    tmax,
)
from opencl_ray_tracer_tpu_torch.kernels.fwd import (
    _check_run_if,
    _out_buffer,
    _select_branch,
    _LIGHT_STRIDE,
    _P_AMBIENT,
    _P_D0,
    _P_DDX,
    _P_DDY,
    _P_DOX,
    _P_DOY,
    _P_LIGHTS,
    _P_O0,
    _P_SHINE,
    _P_SPEC,
    _SHADING_CODES,
    _camera_params,
    _check,
    _cross,
    _prep_affine_coefs,
)
from opencl_ray_tracer_tpu_torch.kernels.fwd_tiled import (
    TILE_H,
    TILE_PIX,
    TILE_W,
    _AABB_SIGNS,
    _bin_prims,
    _prep_projective_coefs,
    _prim_bboxes,
    _prim_z_extents,
    _round_up,
    _tile_hit_z,
)
from opencl_ray_tracer_tpu_torch.kernels.soft import (
    MAX_LIGHTS,
    NEG_BIG,
    PATCH_H,
    PATCH_W,
    _raise_on,
    _safe_norm_rows,
    _prep_soft_arrays,
    _safe_unit_rows,
    _soft_render_core,
    _static_cfg,
    soft_brute_bwd,
    soft_brute_fwd,
)
from opencl_ray_tracer_tpu_torch.ops.intersect import EPSILON
from opencl_ray_tracer_tpu_torch.ops.shading import LEGACY_FOG_MAX
from opencl_ray_tracer_tpu_torch.runtime.graph import (
    _flatten,
    _unflatten,
    cond,
    device_const,
    device_scalar,
)
from opencl_ray_tracer_tpu_torch.utils import tracing
from opencl_ray_tracer_tpu_torch.utils.log import log_warning

# Candidate-list granularity: K caps round to it, and a tile's candidates
# are processed in whole groups of CH rows (the JAX kernels' chunk), so the
# port's bins and its softmax slots compare 1:1 with the JAX package's.
CH = 8
# Coverage sigmoids are exp-small this many tau_edge units outside a
# primitive (16 sigma => sigmoid ~ 1.1e-7): culling is invisible.
SOFT_CULL_SIGMAS = 16.0

# Patches (8 x 4 pixels, one warp of the backward each) in a tile.
TILE_PATCHES = (TILE_H // PATCH_H) * (TILE_W // PATCH_W)

# Elements per (tile batch x candidate x pixel) temporary of the plain twin.
_PLAIN_MAX_ELEMS = 1 << 22


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SoftBins:
    """Candidate index lists for the tiled soft kernels (tensors on the
    scene's device) + static sizes. Depends on the scene, tau_edge (bbox
    pad) and the camera (ortho: its origin offset; pinhole: its pose)."""

    t_idx: torch.Tensor      # (n_tiles, k_tri) int32
    t_valid: torch.Tensor
    s_idx: torch.Tensor      # (n_tiles, k_sph)
    s_valid: torch.Tensor
    tsh_idx: torch.Tensor    # (L, n_tiles, k_sh_tri)
    tsh_valid: torch.Tensor
    ssh_idx: torch.Tensor    # (L, n_tiles, k_sh_sph)
    ssh_valid: torch.Tensor
    counts: torch.Tensor     # (n_tiles, 2 + 2L) int32
    overflow: torch.Tensor   # () bool
    k_tri: int = 0
    k_sph: int = 0
    k_sh_tri: int = 0
    k_sh_sph: int = 0
    nty: int = 0
    ntx: int = 0
    projective: bool = False


def _pinhole_bboxes_soft(packed, camera: Camera, pad):
    """Perspective screen bboxes of primitives inflated by `pad` world units
    (the sigmoid-tail margin): project the 8 corners of each primitive's
    padded AABB; any corner behind the near plane degrades to a full-screen
    bbox."""
    M = torch.stack([camera.ddx, camera.ddy, camera.d0], dim=1)
    Minv = torch.linalg.inv_ex(M)[0]  # inv without its host-side check
    big = 1e9
    signs = device_const(_AABB_SIGNS, camera.device)

    def box_of_aabb(lo, hi):  # (N, 3) each
        ctr = 0.5 * (lo + hi)
        half = 0.5 * (hi - lo) + pad
        P = ctr[:, None, :] + half[:, None, :] * signs[None]
        v = torch.einsum("ij,nkj->nki", Minv, P - camera.o0)
        w = v[..., 2]
        front = w > 1e-6
        ok = torch.all(front, dim=1)
        sw = torch.where(front, w, torch.ones_like(w))
        sx = v[..., 0] / sw
        sy = v[..., 1] / sw
        ppad = 1.0
        neg = torch.full_like(sx[:, 0], -big)
        pos = torch.full_like(sx[:, 0], big)
        return (
            torch.where(ok, sx.amin(1) - ppad, neg),
            torch.where(ok, sx.amax(1) + ppad, pos),
            torch.where(ok, sy.amin(1) - ppad, neg),
            torch.where(ok, sy.amax(1) + ppad, pos),
        )

    v0 = packed.tri_v0.T
    v1 = v0 + packed.tri_e1.T
    v2 = v0 + packed.tri_e2.T
    tri_lo = torch.minimum(torch.minimum(v0, v1), v2)
    tri_hi = torch.maximum(torch.maximum(v0, v1), v2)
    c = packed.sph_origin.T
    r = packed.sph_radius[0][:, None]
    return box_of_aabb(tri_lo, tri_hi), box_of_aabb(c - r, c + r)


def _pad_box(box, pad):
    x0, x1, y0, y1 = box
    return (x0 - pad, x1 + pad, y0 - pad, y1 + pad)


@torch.no_grad()
def _bin_soft(packed, tau_e, camera: Camera, *, height, width, k, shadows,
              shadow_k) -> SoftBins:
    """Tile binning with tau-padded bboxes (a discrete choice: no grad)."""
    dev = packed.device
    projective = camera.normalize
    offs = None if projective else (camera.o0[0], camera.o0[1])
    nty = _round_up(height, TILE_H) // TILE_H
    ntx = _round_up(width, TILE_W) // TILE_W
    n_tiles = nty * ntx
    n_lights = packed.lights.position.shape[0]
    tau_e = device_scalar(tau_e, dev)
    pad = SOFT_CULL_SIGMAS * tau_e
    if projective:
        tri_box, sph_box = _pinhole_bboxes_soft(packed, camera, pad)
    else:
        tri_box, sph_box = _prim_bboxes(packed)
        tri_box = _pad_box(tri_box, pad)
        sph_box = _pad_box(sph_box, pad)

    k_tri = _round_up(min(k, _round_up(packed.n_tris, CH)), CH) if packed.n_tris else 0
    k_sph = (_round_up(min(k, _round_up(packed.n_spheres, CH)), CH)
             if packed.n_spheres else 0)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    zero_cnt = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)

    def empty(lead=()):
        return (torch.zeros(lead + (n_tiles, CH), dtype=torch.int32, device=dev),
                torch.zeros(lead + (n_tiles, CH), dtype=torch.bool, device=dev))

    if k_tri:
        t_idx, t_valid, cnt_tri, over = _bin_prims(
            tri_box, packed.n_tris, nty, ntx, k_tri, offs=offs)
        overflow = overflow | over
    else:
        (t_idx, t_valid), cnt_tri = empty(), zero_cnt
    if k_sph:
        s_idx, s_valid, cnt_sph, over = _bin_prims(
            sph_box, packed.n_spheres, nty, ntx, k_sph, offs=offs)
        overflow = overflow | over
    else:
        (s_idx, s_valid), cnt_sph = empty(), zero_cnt

    # Pinhole shadow rays fan out from anywhere in a tile's frustum: no
    # screen-space corridor bounds them, so their candidates are the full
    # primitive set (one table shared by every tile).
    if projective:
        k_sh_tri = _round_up(packed.padded_tris, CH) if (shadows and packed.n_tris) else 0
        k_sh_sph = (_round_up(packed.padded_spheres, CH)
                    if (shadows and packed.n_spheres) else 0)
    else:
        k_sh_tri = (_round_up(min(shadow_k, _round_up(packed.n_tris, CH)), CH)
                    if (shadows and packed.n_tris) else 0)
        k_sh_sph = (_round_up(min(shadow_k, _round_up(packed.n_spheres, CH)), CH)
                    if (shadows and packed.n_spheres) else 0)
    lpos = packed.lights.position

    # segment-hull shadow culling: z pad = the sigmoid tail + the shadow-ray
    # origin offset; tile_z is the per-tile hit-z slab of the primary lists.
    z_pad = pad + SHADOW_OFFSET
    tri_zext, sph_zext = _prim_z_extents(packed, z_pad)
    tile_z = _tile_hit_z(t_idx, t_valid, s_idx, s_valid, tri_zext, sph_zext,
                         nty, ntx)

    def bin_sh(box, n_real, ksh, prim_z):
        outs = [
            _bin_prims(box, n_real, nty, ntx, ksh,
                       light_xy=(lpos[li, 0], lpos[li, 1]), offs=offs,
                       light_z=lpos[li, 2], prim_z=prim_z, tile_z=tile_z)
            for li in range(n_lights)
        ]
        over = torch.zeros((), dtype=torch.bool, device=dev)
        for o in outs:
            over = over | o[3]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]), over)

    sh_cnt = {}
    for kind, ksh, n_real, box, zext in (
        ("tri", k_sh_tri, packed.n_tris, tri_box, tri_zext),
        ("sph", k_sh_sph, packed.n_spheres, sph_box, sph_zext),
    ):
        cnt = torch.zeros((n_lights, n_tiles), dtype=torch.int32, device=dev)
        if ksh and not projective:
            idx, valid, cnt, over = bin_sh(box, n_real, ksh, zext)
            overflow = overflow | over
        else:
            idx, valid = empty((n_lights,))
            if ksh:  # projective: full shared list, every slot live
                cnt = torch.full_like(cnt, n_real)
        sh_cnt[kind] = (idx, valid, cnt)

    cols = [cnt_tri, cnt_sph]
    for li in range(n_lights):
        cols += [sh_cnt["tri"][2][li], sh_cnt["sph"][2][li]]
    return SoftBins(
        t_idx=t_idx, t_valid=t_valid, s_idx=s_idx, s_valid=s_valid,
        tsh_idx=sh_cnt["tri"][0], tsh_valid=sh_cnt["tri"][1],
        ssh_idx=sh_cnt["sph"][0], ssh_valid=sh_cnt["sph"][1],
        counts=torch.stack(cols, dim=1).to(torch.int32).contiguous(),
        overflow=overflow,
        k_tri=k_tri, k_sph=k_sph, k_sh_tri=k_sh_tri, k_sh_sph=k_sh_sph,
        nty=nty, ntx=ntx, projective=projective,
    )


def soft_bins_for_config(packed, camera: Camera, config: RenderConfig) -> SoftBins:
    """`_bin_soft` at the config's K caps, re-binning with both caps doubled
    while any tile overflows, up to the primitive count (where no list can
    overflow). An opt-in helper that sets the tiled kernels' K outright; it
    is NOT the JAX package's semantics, which render the brute soft frame
    wherever a list overflows its cap (`render_soft_tiled` does that)."""
    k, shadow_k = config.cull_k, config.shadow_cull_k

    def make(k_, sk_):
        return _bin_soft(packed, config.tau_edge, camera, height=config.height,
                         width=config.width, k=k_, shadows=config.shadows,
                         shadow_k=sk_)

    bins = make(k, shadow_k)
    k_max = _round_up(max(packed.n_tris, packed.n_spheres, 1), CH)
    while bool(bins.overflow):
        if k >= k_max and shadow_k >= k_max:
            raise RuntimeError("soft tile candidate overflow at the full K")
        k = max(k, min(2 * k, k_max))
        shadow_k = max(shadow_k, min(2 * shadow_k, k_max))
        log_warning("soft tile candidate overflow: re-binning with cull_k=%d "
                    "shadow_cull_k=%d", k, shadow_k)
        bins = make(k, shadow_k)
    return bins


# ---------------------------------------------------------------------------
# The stored-finals regime: B4 also writes each pixel's streaming finals into
# a block, and B5 reads them there in place of its recompute pass (the
# primary stream and every light's occluder walk). The JAX package's
# `save_finals` / `res_tiles` (soft_tiled.py:1208-1233), chosen as it
# chooses: by the frame's static candidate slot count.
# ---------------------------------------------------------------------------

# Slot count k_tri + k_sph, plus L (k_sh_tri + k_sh_sph) with shadows, from
# which the stored regime is taken (JAX's `_FINALS_MIN_SLOTS`, 128 there: a
# v5e measurement). On an NVIDIA H100 80GB HBM3 at 700 W the stored regime's
# B4 + B5 took less device time than the recompute regime's at every
# configuration measured, from 40 slots (scene 1 at 640x480, lambert) to 592
# (scene 3): 0.120 against 0.140 ms at 40, 0.151 against 0.177 at 64
# (train1080), 2.306 against 2.894 at 432 (stress 1080p), with the loss's
# cotangent; also with a dense one (scripts/torch_kernel_times.py --kernel
# finals, PERF.md). No crossover was found; below 40 slots nothing was
# measured, so the recompute regime keeps those.
_FINALS_MIN_SLOTS = 40

# The block is (n_tiles, TILE_PATCHES, R, 32) float32, patch-major: tile,
# then its 8 x 4 patch (row-major over the tile's 16 x 16 patches), then the
# row, then the patch's 32 pixels (lane 8 * (y % 4) + x % 8), so that a
# warp's store or load of one row is one 128-byte transaction. Its rows are
# the kernels' `Fin` (soft_tiled.cuh) and, with shadows, each light's
# log-visibility; each is given here as (name, the row of the JAX package's
# (n_tiles, R, TILE_PIX) block that holds the same quantity):
#   aggregate shading (phong, lambert + shadows), 13 + L rows:
#     m 0, z 1, st 2, s8[0..5] 3-8 (albedo r, g, b and the ortho triangle
#     normal), snx 11, sny 12, snz 13, bacc 14, logvis[l] 15 + l; JAX's s8
#     rows 9 and 10 sum the albedo table's two zero columns, and its block
#     pads to 8 rows: neither is stored here;
#   per-primitive shading (legacy, lambert without shadows), 6 rows:
#     m 0, z 1, sr 2, sg 3, sb 4, bacc 5; lambert's colour sums are stored
#     before the x 255 of the finish (JAX's rows hold them after it).
# Only the slots of in-frame pixels of non-empty tiles are written, and of
# those the logvis rows only where something covers the pixel (1 - w_bg !=
# 0): B4 walks no occluder of an uncovered pixel, and B5 walks them itself
# where it reads one (the pixel's value is 0, but its gradient reaches the
# coverages through w_bg times the shaded colour, which depends on each
# light's visibility). B5 reads no other slot (its work list holds only
# patches of non-empty tiles).
def _finals_layout(aggregate: bool, n_shadow_lights: int):
    if not aggregate:
        return (("m", 0), ("z", 1), ("sr", 2), ("sg", 3), ("sb", 4), ("bacc", 5))
    return ((("m", 0), ("z", 1), ("st", 2))
            + tuple((f"s8[{a}]", 3 + a) for a in range(6))
            + (("snx", 11), ("sny", 12), ("snz", 13), ("bacc", 14))
            + tuple((f"logvis[{li}]", 15 + li) for li in range(n_shadow_lights)))


def _is_aggregate(shading: str, shadows: bool) -> bool:
    return shading == "phong" or (shadows and shading == "lambert")


def finals_layout(cfg):
    """The rows of a frame's finals block (see `_finals_layout`)."""
    return _finals_layout(_is_aggregate(cfg["shading"], cfg["shadows"]),
                          cfg["n_lights"] if cfg["shadows"] else 0)


def _finals_slots(bins: SoftBins, n_lights: int, shadows: bool) -> int:
    slots = bins.k_tri + bins.k_sph
    if shadows:
        slots += n_lights * (bins.k_sh_tri + bins.k_sh_sph)
    return slots


def _use_stored_finals(bins: SoftBins, n_lights: int, shadows: bool) -> bool:
    return _finals_slots(bins, n_lights, shadows) >= _FINALS_MIN_SLOTS


def finals_block(cfg, device) -> torch.Tensor:
    """An unfilled finals block for the frame of `cfg`, which B4 writes."""
    return torch.empty((cfg["nty"] * cfg["ntx"], TILE_PATCHES,
                        len(finals_layout(cfg)), 32),
                       dtype=torch.float32, device=device)


def _check_finals(finals, cfg, dev):
    if not cfg.get("stored_finals", False):
        raise ValueError("a finals block was given where the slot count "
                         "calls for the recompute regime")
    _check("finals", finals, torch.float32,
           (cfg["nty"] * cfg["ntx"], TILE_PATCHES, len(finals_layout(cfg)), 32),
           dev)


# ---------------------------------------------------------------------------
# Per-frame tables (differentiable)
# ---------------------------------------------------------------------------

# Null rows force cov == 0 EXACTLY (sigmoid underflow), so a null slot
# contributes nothing to the image or the gradients.
_NULL_TRI16 = np.array(
    [-1e9, 0, 0, 0, 0, 0, 0, 0, 0, 1.0, 1.0, 1.0, 0, 0, 0, 0], np.float32)
_NULL_SPH16 = np.array(
    [-1e9, 0, 0, 1e18, 0, 0, 0, 0, 0, 0, 1.0, 0, 0, 0, 1e9, 1.0], np.float32)
_NULL_TSH16 = np.zeros((16,), np.float32)  # zero verts -> det 0 -> cov 0
_NULL_TRI16_PROJ = np.zeros((16,), np.float32)
_NULL_SPH16_PROJ = np.array(
    [-1e9, 0, 0, 0, 0, 1.0, 0, 0, 0, 1e9, 1.0, 0, 0, 0, 0, 0], np.float32)
_NULL_SSH16 = np.array(
    [0, 0, 1e9, 0, 1.0, 1.0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.float32)


def _gather_soft_tables(packed, camera: Camera, tau_e, bins: SoftBins):
    """Per-frame per-tile candidate tables, in differentiable torch ops.

    Shared-direction (ortho) rows:
      tri16    [u0,ux,uy, v0,vx,vy, t0,tx,ty, itu,itv,itw, 0 x4]
      tri_alb8 [r,g,b, n (pre-flipped against the shared dir), 0,0]
      sph16    [tca0,tcax,tcay, d20,d2x,d2y,d2xx,d2yy,d2xy, r2, inv2r, rinv,
                cx,cy,cz, twor]
    Shared-origin (pinhole) rows:
      tri16    [det0,detx,dety, un0,unx,uny, vn0,vnx,vny, tnum, itu,itv,itw,
                n (3) unflipped]
      sph16    [tc0,tcx,tcy, l2, r2, inv2r, rinv, cx,cy,cz, twor, 0 x5]
      and the shadow tables are the full primitive set shared by every tile
      (leading dim 1).
    Common: sph_alb8 [r,g,b, 0 x5]; tri_sh16 [v0, e1, e2, itu,itv,itw, 0 x4];
    sph_sh16 [cx,cy,cz, r2, inv2r, twor, 0 x10].
    Returns (tri_t, tri_alb_t, sph_t, sph_alb_t, tsh_t, ssh_t), contiguous."""
    dev = packed.device
    projective = bins.projective
    tau_e = device_scalar(tau_e, dev)
    e1t, e2t = packed.tri_e1.T, packed.tri_e2.T
    s1 = _safe_norm_rows(e1t)
    s2 = _safe_norm_rows(e2t)
    itu = tmax(s1, 1e-6) / tau_e
    itv = tmax(s2, 1e-6) / tau_e
    itw = tmax(0.5 * (s1 + s2), 1e-6) / tau_e
    tp_ = packed.padded_tris
    sp_ = packed.padded_spheres
    n = _safe_unit_rows(_cross(e1t, e2t))
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731

    r = packed.sph_radius[0]
    twor = tmax(2.0 * r, 1e-6)
    inv2r = 1.0 / twor
    rinv = torch.where(r > 0, 1.0 / torch.where(r > 0, r, torch.ones_like(r)),
                       torch.zeros_like(r))

    if projective:
        tri10, sph5 = _prep_projective_coefs(packed, camera)
        tri16 = torch.cat([tri10, itu[None], itv[None], itw[None], n.T], 0).T
        tri_alb8 = torch.cat([packed.tri_colour.T[:, :3], zeros(tp_, 5)], 1)
        sph16 = torch.cat([sph5, inv2r[None], rinv[None], packed.sph_origin,
                           twor[None], zeros(5, sp_)], 0).T
    else:
        tri9, sph10 = _prep_affine_coefs(packed, camera)
        tri16 = torch.cat([tri9, itu[None], itv[None], itw[None],
                           zeros(4, tp_)], 0).T
        fl = torch.where(torch.sum(n * camera.d0, -1) > 0, -1.0, 1.0)[:, None]
        tri_alb8 = torch.cat([packed.tri_colour.T[:, :3], n * fl,
                              zeros(tp_, 2)], 1)
        sph16 = torch.cat([sph10, inv2r[None], rinv[None], packed.sph_origin,
                           twor[None]], 0).T
    sph_alb8 = torch.cat([packed.sph_colour.T[:, :3], zeros(sp_, 5)], 1)
    tri_sh16 = torch.cat([packed.tri_v0, packed.tri_e1, packed.tri_e2,
                          itu[None], itv[None], itw[None], zeros(4, tp_)], 0).T
    sph_sh16 = torch.cat([packed.sph_origin, (r * r)[None], inv2r[None],
                          twor[None], zeros(10, sp_)], 0).T

    def gather(rows, idx, valid, null):
        # index_select: its backward is one index_add_ (atomic adds), where
        # that of rows[idx] sorts the indices first
        null = device_const(null, dev)
        picked = rows.index_select(0, idx.reshape(-1).long()).reshape(
            *idx.shape, rows.shape[1])
        return torch.where(valid[..., None], picked, null)

    null_tri = _NULL_TRI16_PROJ if projective else _NULL_TRI16
    null_sph = _NULL_SPH16_PROJ if projective else _NULL_SPH16
    tri_t = gather(tri16, bins.t_idx, bins.t_valid, null_tri)
    tri_alb_t = gather(tri_alb8, bins.t_idx, bins.t_valid, 0.0)
    sph_t = gather(sph16, bins.s_idx, bins.s_valid, null_sph)
    sph_alb_t = gather(sph_alb8, bins.s_idx, bins.s_valid, 0.0)
    n_lights = packed.lights.position.shape[0]
    if projective:
        real_t = (torch.arange(tp_, device=dev) < packed.n_tris)[:, None]
        real_s = (torch.arange(sp_, device=dev) < packed.n_spheres)[:, None]
        tsh_rows = torch.where(real_t, tri_sh16, device_const(_NULL_TSH16, dev))
        ssh_rows = torch.where(real_s, sph_sh16, device_const(_NULL_SSH16, dev))
        kt = max(bins.k_sh_tri, CH)
        ks = max(bins.k_sh_sph, CH)

        def pad_rows(rows, kk, null):
            if rows.shape[0] >= kk:
                return rows[:kk]
            extra = device_const(null, dev).expand(kk - rows.shape[0], 16)
            return torch.cat([rows, extra], 0)

        tsh_rows = pad_rows(tsh_rows, kt, _NULL_TSH16)
        ssh_rows = pad_rows(ssh_rows, ks, _NULL_SSH16)
        tsh_t = tsh_rows[None].expand(n_lights, kt, 16).reshape(1, n_lights * kt, 16)
        ssh_t = ssh_rows[None].expand(n_lights, ks, 16).reshape(1, n_lights * ks, 16)
    else:
        tsh_t = torch.cat([gather(tri_sh16, bins.tsh_idx[li], bins.tsh_valid[li],
                                  _NULL_TSH16) for li in range(n_lights)], 1)
        ssh_t = torch.cat([gather(sph_sh16, bins.ssh_idx[li], bins.ssh_valid[li],
                                  _NULL_SSH16) for li in range(n_lights)], 1)
    return tuple(t.contiguous() for t in
                 (tri_t, tri_alb_t, sph_t, sph_alb_t, tsh_t, ssh_t))


def _untile(out, height, width, nty, ntx):
    """(n_tiles, TILE_PIX, C) tile-major rows -> (height, width, C)."""
    c = out.shape[-1]
    img = out.reshape(nty, ntx, TILE_H, TILE_W, c).permute(0, 2, 1, 3, 4)
    return img.reshape(nty * TILE_H, ntx * TILE_W, c)[:height, :width]


# ---------------------------------------------------------------------------
# The plain twin: the kernels' function as vectorised torch over
# (tile batch, candidate, pixel). Same formulas and the same processed
# slots as the JAX kernels; autograd of it is B5's plain version.
# ---------------------------------------------------------------------------

def _ctx_make(pv, tau_d, tau_e, x, y, *, projective, n_lights):
    """Per-pixel context: ray bundle, quadratic pixel terms, light and
    shading scalars, temperatures. x, y: (nb, 1, P)."""
    o = tuple(pv[_P_O0 + q] + x * pv[_P_DOX + q] + y * pv[_P_DOY + q]
              for q in range(3))
    if projective:
        du = tuple(_aff(pv[_P_D0 + q], pv[_P_DDX + q], pv[_P_DDY + q], x, y)
                   for q in range(3))
        len2 = tmax(du[0] * du[0] + du[1] * du[1] + du[2] * du[2], 1e-20)
        inv_len = 1.0 / torch.sqrt(len2)
        len_d = len2 * inv_len
        d = tuple(c_ * inv_len for c_ in du)
        quad = None
    else:
        d = (pv[_P_D0], pv[_P_D0 + 1], pv[_P_D0 + 2])
        inv_len = len_d = None
        quad = (x * x, y * y, x * y)
    lights = tuple(
        ((pv[b], pv[b + 1], pv[b + 2]), (pv[b + 3], pv[b + 4], pv[b + 5]),
         pv[b + 6])
        for b in (_P_LIGHTS + li * _LIGHT_STRIDE for li in range(n_lights))
    )
    return dict(o=o, d=d, inv_len=inv_len, len_d=len_d, quad=quad, x=x, y=y,
                ambient=pv[_P_AMBIENT], spec=pv[_P_SPEC], shine=pv[_P_SHINE],
                lights=lights, tau_e=tau_e, inv_td=1.0 / tau_d,
                inv_te=1.0 / tau_e, inv_te6=1.0 / tmax(tau_e, 1e-6))


def _cols(tab):
    return lambda q: tab[:, :, q:q + 1]


def _fma(a, b, c):
    """a * b + c rounded once, as an FMA: the pixel-affine evaluations
    below cancel heavily (|L|^2 - tca^2 ~ r^2), and both the JAX package
    (XLA contracts a * b + c into FMAs) and the CUDA kernels (fmaf) round
    them once per step. The float64 product of two float32 values is
    exact, so this matches fmaf up to a rare double rounding."""
    return (a.double() * b.double() + c.double()).float()


def _aff(c0, c1, c2, x, y):
    """c0 + x * c1 + y * c2 as two FMAs."""
    return _fma(y, c2, _fma(x, c1, c0))


def _tri_test(tab, ctx, projective):
    """-> (t, cov, n or None); ortho normals ride the albedo table."""
    x, y = ctx["x"], ctx["y"]
    c = _cols(tab)
    if projective:
        d, len_d = ctx["d"], ctx["len_d"]
        det = _aff(c(0), c(1), c(2), x, y)
        un = _aff(c(3), c(4), c(5), x, y)
        vn = _aff(c(6), c(7), c(8), x, y)
        det_ok = torch.abs(det) >= EPSILON * len_d
        inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
        u = un * inv_det
        v = vn * inv_det
        t = c(9) * inv_det * len_d
        cov = (torch.sigmoid(u * c(10)) * torch.sigmoid(v * c(11))
               * torch.sigmoid((1.0 - u - v) * c(12)))
        cov = torch.where(det_ok, cov, torch.zeros_like(cov))
        n0 = (c(13), c(14), c(15))
        ndotd = n0[0] * d[0] + n0[1] * d[1] + n0[2] * d[2]
        fl = torch.where(ndotd > 0, -1.0, 1.0)
        return t, cov, (n0[0] * fl, n0[1] * fl, n0[2] * fl)
    u = _aff(c(0), c(1), c(2), x, y)
    v = _aff(c(3), c(4), c(5), x, y)
    t = _aff(c(6), c(7), c(8), x, y)
    cov = (torch.sigmoid(u * c(9)) * torch.sigmoid(v * c(10))
           * torch.sigmoid((1.0 - u - v) * c(11)))
    return t, cov, None


def _sph_cov_t(tca, d2, r2, inv2r, twor, ctx):
    margin = (r2 - d2) * inv2r
    cov = torch.sigmoid(margin * ctx["inv_te"]) * torch.sigmoid(tca * ctx["inv_te6"])
    q_ = r2 - d2
    beta = tmax(ctx["tau_e"], 1e-3) * twor
    thc = torch.sqrt(beta * softplus(q_ / beta) + 1e-12)
    return tca - thc, cov


def _sph_test(tab, ctx, projective):
    x, y = ctx["x"], ctx["y"]
    o, d = ctx["o"], ctx["d"]
    c = _cols(tab)
    if projective:
        tca = _aff(c(0), c(1), c(2), x, y) * ctx["inv_len"]
        d2 = _fma(-tca, tca, c(3))
        r2, inv2r, rinv = c(4), c(5), c(6)
        ctr = (c(7), c(8), c(9))
        twor = c(10)
    else:
        x2, y2, xy = ctx["quad"]
        tca = _aff(c(0), c(1), c(2), x, y)
        d2 = _fma(xy, c(8), _fma(y2, c(7), _fma(x2, c(6),
                                                 _aff(c(3), c(4), c(5), x, y))))
        r2, inv2r, rinv = c(9), c(10), c(11)
        ctr = (c(12), c(13), c(14))
        twor = c(15)
    t, cov = _sph_cov_t(tca, d2, r2, inv2r, twor, ctx)
    n = tuple((o[q] + t * d[q] - ctr[q]) * rinv for q in range(3))
    return t, cov, n


def _tri_sh_test(tab, so, sd, ctx):
    c = _cols(tab)
    v0 = (c(0), c(1), c(2))
    e1 = (c(3), c(4), c(5))
    e2 = (c(6), c(7), c(8))
    pvx = sd[1] * e2[2] - sd[2] * e2[1]
    pvy = sd[2] * e2[0] - sd[0] * e2[2]
    pvz = sd[0] * e2[1] - sd[1] * e2[0]
    det = e1[0] * pvx + e1[1] * pvy + e1[2] * pvz
    det_ok = torch.abs(det) >= EPSILON
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    tvx, tvy, tvz = so[0] - v0[0], so[1] - v0[1], so[2] - v0[2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1[2] - tvz * e1[1]
    qvy = tvz * e1[0] - tvx * e1[2]
    qvz = tvx * e1[1] - tvy * e1[0]
    v = (sd[0] * qvx + sd[1] * qvy + sd[2] * qvz) * inv_det
    t = (e2[0] * qvx + e2[1] * qvy + e2[2] * qvz) * inv_det
    cov = (torch.sigmoid(u * c(9)) * torch.sigmoid(v * c(10))
           * torch.sigmoid((1.0 - u - v) * c(11)))
    return t, torch.where(det_ok, cov, torch.zeros_like(cov))


def _sph_sh_test(tab, so, sd, ctx):
    c = _cols(tab)
    lx, ly, lz = c(0) - so[0], c(1) - so[1], c(2) - so[2]
    tca = lx * sd[0] + ly * sd[1] + lz * sd[2]
    d2 = lx * lx + ly * ly + lz * lz - tca * tca
    return _sph_cov_t(tca, d2, c(3), c(4), c(5), ctx)


def _rank(t, cov, ctx):
    return torch.where(cov > 1e-12,
                       -t * ctx["inv_td"] + torch.log(tclip(cov, 1e-12, 1.0)),
                       torch.full_like(t, NEG_BIG))


def _log_unocc(cov):
    return torch.log1p(-tclip(cov, 0.0, 1.0 - 1e-6))


def _processed(cnt, k, dev):
    """(nb, k, 1) mask of the slots the kernels process: whole groups of CH
    rows up to the candidate count."""
    n = torch.clamp((cnt + CH - 1) // CH * CH, max=k)
    return (torch.arange(k, device=dev)[None, :] < n[:, None])[..., None]


def _candidates(tri_t, tri_alb, sph_t, sph_alb, cnt, ctx, projective,
                m_in=None):
    """Candidate planes of a tile batch, tris then spheres along dim 1: t,
    cov, explicit normals (zero planes where the normal rides the albedo
    table), albedo columns, the weights e = exp(logit - m), the background's
    log sum and the softmin's m. `m_in` (m, valid): m from a finals block
    where valid, in place of the maximum logit."""
    dev = tri_t.device
    t1, c1, n1 = _tri_test(tri_t, ctx, projective)
    t2, c2, n2 = _sph_test(sph_t, ctx, projective)
    if n1 is None:
        n1 = (torch.zeros_like(t1),) * 3
    t = torch.cat([t1, t2], 1)
    cov = torch.cat([c1, c2], 1)
    n = tuple(torch.cat([a, b], 1) for a, b in zip(n1, n2))
    alb = torch.cat([tri_alb, sph_alb], 1)           # (nb, K, 8)
    proc = torch.cat([_processed(cnt[:, 0], tri_t.shape[1], dev),
                      _processed(cnt[:, 1], sph_t.shape[1], dev)], 1)
    logit = _rank(t, cov, ctx)
    with torch.no_grad():  # outputs do not depend on m: its gradient is 0
        m = torch.where(proc, logit, float("-inf")).amax(1, keepdim=True)
        if m_in is not None:
            m = torch.where(m_in[1], m_in[0], m)
    e = torch.where(proc, torch.exp(logit - m), torch.zeros_like(logit))
    bacc = torch.sum(torch.where(proc, _log_unocc(cov), torch.zeros_like(cov)),
                     1, keepdim=True)
    return t, cov, n, alb, e, bacc, m


def _sum(a):
    return torch.sum(a, 1, keepdim=True)


def _occ_logvis(tab, n_rows, so, sd, dist, ctx, test):
    """Sum over processed occluder rows of log(1 - occ) for one light."""
    t2, cov2 = test(tab, so, sd, ctx)
    tau_g = tmax(ctx["tau_e"], 1e-4)
    shift = tmax(4.0 * tau_g, SHADOW_T_MIN)
    occ = (cov2 * torch.sigmoid((t2 - shift) / tau_g)
           * torch.sigmoid((dist - t2) / tau_g))
    proc = _processed(n_rows, tab.shape[1], tab.device)
    return _sum(torch.where(proc, _log_unocc(occ), torch.zeros_like(occ)))


def _tile_batch(params, taus, tabs, cnt, x, y, *, cfg, stored=None,
                want_finals=False):
    """(nb, 1, P) r, g, b planes of one batch of non-empty tiles, and with
    `want_finals` the rows of their finals block (`finals_layout`) as
    planes. `stored` (rows, valid): B5's stored regime, where valid the
    finals take their values from the block's rows and their gradients from
    the stream recomputed here; the log-visibilities too, but at the pixels
    that something covers only (see `_finals_layout`)."""
    tri_t, tri_alb, sph_t, sph_alb, tsh, ssh = tabs
    projective, shading = cfg["projective"], cfg["shading"]
    n_lights = cfg["n_lights"]
    pv = [params[i] for i in range(params.shape[0])]
    ctx = _ctx_make(pv, taus[0], taus[1], x, y, projective=projective,
                    n_lights=n_lights)
    o, d = ctx["o"], ctx["d"]
    rows_in, valid = stored if stored is not None else (None, None)

    def fin(i, rec, where=None):
        # the block's value exactly (rec - rec.detach() is exactly 0), the
        # recomputed stream's gradient
        if rows_in is None:
            return rec
        return (torch.where(valid if where is None else where, rows_in[i],
                            rec.detach()) + (rec - rec.detach()))

    t, cov, n, alb, e, bacc, m = _candidates(
        tri_t, tri_alb, sph_t, sph_alb, cnt, ctx, projective,
        None if rows_in is None else (rows_in[0], valid))
    z = fin(1, _sum(e))
    zinv = 1.0 / tmax(z, 1e-20)
    aggregate = _is_aggregate(shading, cfg["shadows"])
    if not aggregate:
        bacc = fin(5, bacc)
        w_bg = torch.exp(bacc)
        a = [alb[:, :, q:q + 1] for q in range(6)]
        if shading == "legacy":
            st = e * (255.0 - t * (255.0 / LEGACY_FOG_MAX))
            s = [fin(2 + q, _sum(a[q] * st)) for q in range(3)]
            sums = s
        else:  # lambert, no shadows
            p = tuple(o[q] + t * d[q] for q in range(3))
            # ortho triangle normals live in the albedo table; elsewhere
            # those albedo columns are 0 and the normal plane carries them
            nn = tuple(n[q] + a[3 + q] for q in range(3))
            acc = [_sum(a[q] * e) * ctx["ambient"] for q in range(3)]
            for lp, lc, lint in ctx["lights"]:
                tl = tuple(lp[q] - p[q] for q in range(3))
                dist = torch.sqrt(tmax(tl[0] * tl[0] + tl[1] * tl[1]
                                       + tl[2] * tl[2], 1e-20))
                ndotl = tmax((nn[0] * tl[0] + nn[1] * tl[1] + nn[2] * tl[2])
                             / dist, 0.0)
                ew = e * (lint * ndotl)
                for q in range(3):
                    acc[q] = acc[q] + lc[q] * _sum(a[q] * ew)
            sums = [fin(2 + q, acc[q]) for q in range(3)]
            s = [sums[q] * 255.0 for q in range(3)]
        rgb = [(1.0 - w_bg) * s[q] * zinv for q in range(3)]
        if shading != "legacy":
            rgb = [tclip(c_, 0.0, 255.0) for c_ in rgb]
        return (rgb, [m, z] + sums + [bacc]) if want_finals else rgb

    # aggregate: softmax-expected hit attributes, then one shading per pixel
    bacc = fin(12, bacc)
    w_bg = torch.exp(bacc)
    lv_valid = None if rows_in is None else valid & (1.0 - w_bg != 0.0)
    st = fin(2, _sum(e * t))
    s8 = [fin(3 + q, _sum(alb[:, :, q:q + 1] * e)) for q in range(6)]
    sn = [fin(9 + q, _sum(e * n[q])) for q in range(3)]
    rows = [m, z, st] + s8 + sn + [bacc]
    t_hat = st * zinv
    nrm = [(s8[3 + q] + sn[q]) * zinv for q in range(3)]
    ninv = 1.0 / torch.sqrt(tmax(nrm[0] * nrm[0] + nrm[1] * nrm[1]
                                 + nrm[2] * nrm[2], 1e-20))
    nrm = [c_ * ninv for c_ in nrm]
    alb3 = [s8[q] * zinv for q in range(3)]
    p = [o[q] + t_hat * d[q] for q in range(3)]
    vinv = 1.0 / torch.sqrt(tmax(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-20))
    v = [-d[q] * vinv for q in range(3)]
    diff = [0.0, 0.0, 0.0]
    spec = [0.0, 0.0, 0.0]
    sh_tri = tsh.shape[1] // n_lights
    sh_sph = ssh.shape[1] // n_lights
    for li, (lp, lc, lint) in enumerate(ctx["lights"]):
        tl = [lp[q] - p[q] for q in range(3)]
        dist = torch.sqrt(tmax(tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2],
                               1e-20))
        sd = [tl[q] / dist for q in range(3)]
        if cfg["shadows"]:
            so = [p[q] + SHADOW_OFFSET * nrm[q] for q in range(3)]
            logvis = fin(13 + li, (
                _occ_logvis(tsh[:, li * sh_tri:(li + 1) * sh_tri],
                            cnt[:, 2 + 2 * li], so, sd, dist, ctx, _tri_sh_test)
                + _occ_logvis(ssh[:, li * sh_sph:(li + 1) * sh_sph],
                              cnt[:, 3 + 2 * li], so, sd, dist, ctx,
                              _sph_sh_test)), lv_valid)
            rows.append(logvis)
            vis = torch.exp(logvis)
        else:
            vis = 1.0
        ndl = nrm[0] * sd[0] + nrm[1] * sd[1] + nrm[2] * sd[2]
        ndotl = tmax(ndl, 0.0)
        wd = lint * ndotl * vis
        for q in range(3):
            diff[q] = diff[q] + wd * lc[q]
        if shading == "phong":
            two_ndl = 2.0 * ndl
            r = [two_ndl * nrm[q] - sd[q] for q in range(3)]
            rdotv = tmax(r[0] * v[0] + r[1] * v[1] + r[2] * v[2], 0.0)
            ws = (ctx["spec"] * torch.exp(ctx["shine"] * torch.log(tmax(rdotv, 1e-20)))
                  * lint * vis * (ndotl > 0.0))
            for q in range(3):
                spec[q] = spec[q] + ws * lc[q]
    rgb = [tclip((1.0 - w_bg) * (alb3[q] * (ctx["ambient"] + diff[q]) + spec[q])
                 * 255.0, 0.0, 255.0) for q in range(3)]
    return (rgb, rows) if want_finals else rgb


def _planes_to_block(planes):
    """(nb, R, TILE_PIX) tile-major rows -> (nb, TILE_PATCHES, R, 32) of the
    finals block's patch-major layout."""
    nb, r = planes.shape[:2]
    return planes.reshape(nb, r, TILE_H // PATCH_H, PATCH_H, TILE_W // PATCH_W,
                          PATCH_W).permute(0, 2, 4, 1, 3, 5).reshape(
                              nb, TILE_PATCHES, r, PATCH_H * PATCH_W)


def _block_to_planes(block):
    """The inverse of `_planes_to_block`."""
    nb, _, r, _ = block.shape
    return block.reshape(nb, TILE_H // PATCH_H, TILE_W // PATCH_W, r, PATCH_H,
                         PATCH_W).permute(0, 3, 1, 4, 2, 5).reshape(nb, r, TILE_PIX)


def _soft_tiled_plain(params, taus, tables, counts, *, cfg, want_finals=False,
                      finals=None):
    """The tiled soft forward as vectorised torch; differentiable in params,
    taus and the six tables. Tiles are processed in batches that bound each
    temporary to _PLAIN_MAX_ELEMS elements. Returns (H, W, 4) float32;
    empty tiles hold the background (0, 0, 0, 255). `want_finals`: also the
    finals block B4 writes, NaN in the slots it does not write (outside the
    frame, in empty tiles, and the logvis rows of a pixel that nothing
    covers). `finals`: a
    block to read as B5's stored regime reads it (see `_tile_batch`)."""
    tri_t, tri_alb, sph_t, sph_alb, tsh_t, ssh_t = tables
    dev = params.device
    nty, ntx = cfg["nty"], cfg["ntx"]
    n_tiles = nty * ntx
    out = torch.zeros((n_tiles, TILE_PIX, 4), dtype=torch.float32, device=dev)
    out[..., 3] = 255.0
    if want_finals:
        block = torch.full((n_tiles, TILE_PATCHES, len(finals_layout(cfg)),
                            PATCH_H * PATCH_W), float("nan"), device=dev)
    lane = torch.arange(TILE_PIX, device=dev)
    lx = (lane % TILE_W).to(torch.float32)
    lrow = (lane // TILE_W).to(torch.float32)
    nonempty = torch.nonzero((counts[:, 0] + counts[:, 1]) > 0).flatten()
    k_max = max(tri_t.shape[1] + sph_t.shape[1], tsh_t.shape[1], ssh_t.shape[1])
    nb = max(1, _PLAIN_MAX_ELEMS // (TILE_PIX * k_max))
    shared_sh = cfg["projective"]  # one shadow table for every tile
    # (split gives one empty batch for an empty list: a frame with no candidate)
    for tb in nonempty.split(nb) if nonempty.numel() else ():
        ty = tb // ntx
        tx = tb - ty * ntx
        x = ((tx * TILE_W).to(torch.float32)[:, None] + lx)[:, None, :]
        y = ((ty * TILE_H).to(torch.float32)[:, None] + lrow)[:, None, :]
        in_frame = (x < cfg["width"]) & (y < cfg["height"])
        stored = None
        if finals is not None:
            planes = _block_to_planes(finals[tb])
            stored = ([planes[:, i:i + 1] for i in range(planes.shape[1])],
                      in_frame)
        tabs = (tri_t[tb], tri_alb[tb], sph_t[tb], sph_alb[tb],
                tsh_t[0:1] if shared_sh else tsh_t[tb],
                ssh_t[0:1] if shared_sh else ssh_t[tb])
        rgb = _tile_batch(params, taus, tabs, counts[tb].long(), x, y, cfg=cfg,
                          stored=stored, want_finals=want_finals)
        if want_finals:
            rgb, rows = rgb
            nan = torch.full((), float("nan"), device=dev)
            planes = torch.where(in_frame, torch.cat(rows, 1), nan)
            if len(rows) > 13:  # no logvis row where nothing covers the pixel
                covered = 1.0 - torch.exp(planes[:, 12:13]) != 0.0
                planes = torch.cat([planes[:, :13], torch.where(
                    covered, planes[:, 13:], nan)], 1)
            block = block.index_copy(0, tb, _planes_to_block(planes))
        res = torch.cat([c_.reshape(tb.shape[0], TILE_PIX, 1) for c_ in rgb]
                        + [torch.full((tb.shape[0], TILE_PIX, 1), 255.0,
                                      device=dev)], -1)
        out = out.index_copy(0, tb, res)
    img = _untile(out, cfg["height"], cfg["width"], nty, ntx)
    return (img, block) if want_finals else img


# ---------------------------------------------------------------------------
# Kernel wrappers + the autograd Function
# ---------------------------------------------------------------------------

def _check_inputs(params, taus, tables, counts, cfg):
    dev = params.device
    n_tiles = cfg["nty"] * cfg["ntx"]
    n_lights = cfg["n_lights"]
    if not 1 <= n_lights <= MAX_LIGHTS:
        raise ValueError(f"the soft kernels take 1-{MAX_LIGHTS} lights, got {n_lights}")
    if params.shape != (_P_LIGHTS + n_lights * _LIGHT_STRIDE,):
        raise ValueError(f"params shape {tuple(params.shape)} is not (21 + 7L,)")
    if cfg["nty"] * TILE_H < cfg["height"] or cfg["ntx"] * TILE_W < cfg["width"]:
        raise ValueError("tile grid does not cover the frame")
    _check("params", params, torch.float32, device=dev)
    _check("taus", taus, torch.float32, (2,), dev)
    _check("counts", counts, torch.int32, (n_tiles, 2 + 2 * n_lights), dev)
    tri_t, tri_alb, sph_t, sph_alb, tsh_t, ssh_t = tables
    _check("tri_t", tri_t, torch.float32, (n_tiles, tri_t.shape[1], 16), dev)
    _check("tri_alb", tri_alb, torch.float32, (n_tiles, tri_t.shape[1], 8), dev)
    _check("sph_t", sph_t, torch.float32, (n_tiles, sph_t.shape[1], 16), dev)
    _check("sph_alb", sph_alb, torch.float32, (n_tiles, sph_t.shape[1], 8), dev)
    sh_tiles = 1 if cfg["projective"] else n_tiles
    for name, tab in (("tsh_t", tsh_t), ("ssh_t", ssh_t)):
        _check(name, tab, torch.float32, device=dev)
        if (tab.dim() != 3 or tab.shape[0] != sh_tiles or tab.shape[2] != 16
                or tab.shape[1] % n_lights):
            raise ValueError(f"{name}: bad shadow table shape {tuple(tab.shape)}")


def _launch_args(params, taus, tables, counts, cfg):
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    tri_t, _, sph_t, _, tsh_t, ssh_t = tables
    n_lights = cfg["n_lights"]
    ptrs = [p(params), p(taus), p(counts)] + [p(t) for t in tables]
    ints = [cfg["height"], cfg["width"], cfg["ntx"], cfg["nty"] * cfg["ntx"],
            tri_t.shape[1], sph_t.shape[1], tsh_t.shape[1] // n_lights,
            ssh_t.shape[1] // n_lights, n_lights, _SHADING_CODES[cfg["shading"]],
            int(bool(cfg["shadows"])), int(bool(cfg["projective"]))]
    return ptrs, ints


def soft_tiled_fwd(params, taus, tables, counts, *, cfg, run_if=None,
                   want: int = 0, finals=None) -> torch.Tensor:
    """B4, the tiled soft forward -> (H, W, 4) float32. CUDA tensors launch
    kernels/csrc/soft_tiled.cu (built on first use) or raise; CPU tensors
    run `_soft_tiled_plain` without autograd. `run_if` (one int32 on the
    device, or None) is the device-side branch of `lax.cond`: the kernel
    does its work only where *run_if == want, else its frame is zeros (the
    twin: a torch.where). `finals` (`finals_block`, only where cfg's
    "stored_finals" is set): the kernel also writes the frame's streaming
    finals there, for B5's stored regime; a skipped launch writes none."""
    dev = params.device
    _check_run_if(run_if, dev)
    if finals is not None:
        _check_finals(finals, cfg, dev)
    if dev.type == "cpu":
        with torch.no_grad():
            img = _soft_tiled_plain(params, taus, tables, counts, cfg=cfg,
                                    want_finals=finals is not None)
            if finals is not None:
                img, block = img
                finals.copy_(block)
            return _select_branch(img, run_if, want)
    if dev.type != "cuda":
        raise ValueError(f"soft_tiled_fwd runs on cuda or cpu tensors, got {dev}")
    return _soft_tiled_fwd_cuda(params, taus, tables, counts, cfg, run_if,
                                want, finals)[0]


def _soft_tiled_fwd_cuda(params, taus, tables, counts, cfg, run_if=None,
                         want=0, finals=None):
    """Launch B4 on CUDA tensors -> (frame, tiles). `tiles` is the int32
    list of non-empty tiles that the kernel's blocks build from `counts`
    (kernels/csrc/tile_list.cuh): tiles[0] their number, tiles[2 : 2 +
    tiles[0]] the tiles in ascending order (`fwd_tiled._live_tiles` is its
    plain version), then the empty ones. With `run_if`, both start as
    zeros, which a skipped launch leaves. `finals`: see `soft_tiled_fwd`."""
    dev = params.device
    _check_inputs(params, taus, tables, counts, cfg)
    if finals is not None:
        _check_finals(finals, cfg, dev)
    from opencl_ray_tracer_tpu_torch.kernels._build import load_library

    lib = load_library()
    out = _out_buffer((cfg["height"], cfg["width"], 4), torch.float32, dev,
                      run_if)
    tiles = _out_buffer((2 + cfg["nty"] * cfg["ntx"],), torch.int32, dev, run_if)
    ptrs, ints = _launch_args(params, taus, tables, counts, cfg)
    p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.octrt_soft_tiled_fwd(*ptrs, p(out), p(tiles), p(finals), *ints,
                                      p(run_if), int(want),
                                      ctypes.c_void_p(stream))
    _raise_on(rc, "soft_tiled forward")
    tracing.count("launch.B4")
    if finals is not None:
        tracing.count("launch.B4_finals")
    return out, tiles


def _live_patches(g, counts, *, cfg):
    """The backward's work list in its plain version: the 8 x 4 patches of
    the non-empty tiles (counts[:, 0] + counts[:, 1] > 0) that hold a pixel
    whose cotangent g (H, W, 4) is non-zero in a colour channel (alpha is a
    constant: its cotangent reaches nothing), as sorted codes tile * 256 +
    patch, the patch row-major over the tile's 16 x 16 patches. The CUDA
    backward builds this list on the card (in no order) and walks nothing
    else."""
    h, w = cfg["height"], cfg["width"]
    nty, ntx = cfg["nty"], cfg["ntx"]
    nz = torch.zeros((nty * TILE_H, ntx * TILE_W), dtype=torch.bool,
                     device=g.device)
    nz[:h, :w] = (g[..., :3] != 0).any(-1)
    live = nz.reshape(nty, TILE_H // PATCH_H, PATCH_H, ntx, TILE_W // PATCH_W,
                      PATCH_W).any(5).any(2)            # (nty, 16, ntx, 16)
    live = live.permute(0, 2, 1, 3).reshape(nty * ntx, TILE_PATCHES)
    live = live & ((counts[:, 0] + counts[:, 1]) > 0)[:, None]
    return torch.nonzero(live.reshape(-1))[:, 0]


def _zero_grads(inputs):
    """One zeroed gradient per (contiguous) input, each a view of one
    allocation (one fill, not eight): same shapes, no two overlapping, every
    view starting on a 16-byte boundary of the buffer."""
    starts, total = [], 0
    for t in inputs:
        starts.append(total)
        total += -(-t.numel() // 4) * 4
    buf = torch.zeros(total, dtype=torch.float32, device=inputs[0].device)
    return [buf.as_strided(t.shape, t.stride(), start)
            for t, start in zip(inputs, starts)]


def soft_tiled_bwd(params, taus, tables, counts, g, *, cfg, finals=None):
    """B5, the tiled soft backward: pixel cotangents g (H, W, 4) -> gradients
    of (params, taus, *tables). CUDA tensors launch the CUDA backward (it
    works only on the patches of non-empty tiles where g is non-zero,
    recomputes the forward per pixel there and sums over pixels with
    atomics, so sums vary in their last bits from run to run); CPU tensors
    take autograd of `_soft_tiled_plain`. `finals`, the block that B4 wrote
    for these inputs (only where cfg's "stored_finals" is set): the stored
    regime, which reads each pixel's finals and log-visibilities there and
    does not recompute them."""
    dev = params.device
    inputs = (params, taus) + tuple(tables)
    if finals is not None:
        _check_finals(finals, cfg, dev)
    if dev.type == "cpu":
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in inputs]
            out = _soft_tiled_plain(leaves[0], leaves[1], leaves[2:], counts,
                                    cfg=cfg, finals=finals)
            if not out.requires_grad:  # no candidate in any tile
                return tuple(torch.zeros_like(t) for t in inputs)
            grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
        return tuple(torch.zeros_like(t) if gr is None else gr
                     for t, gr in zip(inputs, grads))
    if dev.type != "cuda":
        raise ValueError(f"soft_tiled_bwd runs on cuda or cpu tensors, got {dev}")
    return _soft_tiled_bwd_cuda(params, taus, tables, counts, g, cfg,
                                finals)[0]


def _soft_tiled_bwd_cuda(params, taus, tables, counts, g, cfg, finals=None):
    """Launch B5 on CUDA tensors -> (the eight gradients, live). `live` is
    the kernel's int32 work list as it leaves it: live[0] the number of
    entries, live[2 : 2 + live[0]] the entries in no order
    (`_live_patches` is its plain version). `finals`: see `soft_tiled_bwd`."""
    dev = params.device
    _check_inputs(params, taus, tables, counts, cfg)
    if finals is not None:
        _check_finals(finals, cfg, dev)
    g = g.to(torch.float32).contiguous()
    _check("g", g, torch.float32, (cfg["height"], cfg["width"], 4), dev)
    from opencl_ray_tracer_tpu_torch.kernels._build import load_library

    lib = load_library()
    d_par, d_tau, *d_tables = _zero_grads((params, taus) + tuple(tables))
    live = torch.empty(2 + TILE_PATCHES * cfg["nty"] * cfg["ntx"],
                       dtype=torch.int32, device=dev)
    ptrs, ints = _launch_args(params, taus, tables, counts, cfg)
    p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.octrt_soft_tiled_bwd(*ptrs, p(g), p(finals),
                                      *(p(t) for t in d_tables),
                                      p(d_par), p(d_tau), p(live), *ints,
                                      ctypes.c_void_p(stream))
    _raise_on(rc, "soft_tiled backward")
    tracing.count("launch.B5")
    if finals is not None:
        tracing.count("launch.B5_finals")
    return (d_par, d_tau) + tuple(d_tables), live


class SoftTiledFunction(torch.autograd.Function):
    """(params, taus, tri_t, tri_alb, sph_t, sph_alb, tsh_t, ssh_t) + the
    non-differentiable counts and cfg -> (H, W, 4) float image. Forward is
    B4 and backward B5 on CUDA tensors; the plain twin on CPU tensors. Where
    cfg's "stored_finals" is set and a gradient is wanted, the forward
    writes a finals block that the backward reads (the JAX custom_vjp's
    `save_finals`); an inference forward stays lean. With `run_if` the
    forward is a branch of `lax.cond` (see `soft_tiled_fwd`); the backward
    needs no flag: the branch not taken gets a zero cotangent, on which B5
    returns exact zeros and reads no pixel of the block."""

    @staticmethod
    def forward(ctx, params, taus, tri_t, tri_alb, sph_t, sph_alb, tsh_t,
                ssh_t, counts, cfg, run_if=None, want=0):
        tables = (tri_t, tri_alb, sph_t, sph_alb, tsh_t, ssh_t)
        finals = None
        if cfg.get("stored_finals", False) and any(ctx.needs_input_grad[:8]):
            finals = finals_block(cfg, params.device)
        ctx.save_for_backward(params, taus, *tables, counts, finals)
        ctx.cfg = cfg
        return soft_tiled_fwd(params, taus, tables, counts, cfg=cfg,
                              run_if=run_if, want=want, finals=finals)

    @staticmethod
    def backward(ctx, g):
        params, taus, *tables, counts, finals = ctx.saved_tensors
        grads = soft_tiled_bwd(params, taus, tables, counts, g, cfg=ctx.cfg,
                               finals=finals)
        return tuple(grads) + (None, None, None, None)


def soft_kernel_inputs(packed, camera: Camera, config: RenderConfig,
                       bins: SoftBins = None):
    """(params, taus, tables, counts, cfg) of a frame; params and tables
    carry autograd history back to the packed scene and the camera. `bins`
    None bins through `soft_bins_for_config`, the opt-in escalating helper
    (not the JAX package's semantics: see `render_soft_tiled`). cfg's
    "stored_finals" is the regime that these bins' slot count calls for."""
    if bins is None:
        bins = soft_bins_for_config(packed, camera, config)
    if bins.projective != camera.normalize:
        raise ValueError("SoftBins/camera mismatch: bin with this camera")
    dev = packed.device
    tables = _gather_soft_tables(packed, camera, config.tau_edge, bins)
    params = _camera_params(camera, packed.lights).contiguous()
    taus = device_const([config.tau_depth, config.tau_edge], dev)
    n_lights = packed.lights.position.shape[0]
    cfg = dict(n_lights=n_lights, shading=config.shading,
               shadows=config.shadows, projective=bins.projective,
               nty=bins.nty, ntx=bins.ntx, height=config.height,
               width=config.width,
               stored_finals=_use_stored_finals(bins, n_lights, config.shadows))
    return params, taus, tables, bins.counts, cfg


def _soft_operands(brute: bool, packed, camera: Camera, tau_d, tau_e,
                   bins: SoftBins, frame):
    """(kernel inputs, cfg) of one branch of `_soft_tiled_core`, in
    differentiable torch ops: for the tiled kernels (B4, B5) the camera
    parameters, the two taus and the six gathered tables; for the brute
    ones (B6, B7) the camera parameters, the taus and the four primitive
    arrays."""
    # in the order of the eager paths (`soft_kernel_inputs`,
    # `_soft_render_core`), so that autograd sums each leaf's gradient in
    # the same order and the two agree bit for bit
    height, width, shading, shadows = frame[:4]
    if brute:
        arrays = [a.contiguous() for a in _prep_soft_arrays(packed)]
    else:
        arrays = list(_gather_soft_tables(packed, camera, tau_e, bins))
    params = _camera_params(camera, packed.lights).contiguous()
    taus = torch.stack([tau_d, tau_e])
    if brute:
        return ([params, taus] + arrays,
                _static_cfg(packed, shading, shadows, camera.normalize))
    n_lights = packed.lights.position.shape[0]
    cfg = dict(n_lights=n_lights, shading=shading, shadows=shadows,
               projective=bins.projective, nty=bins.nty, ntx=bins.ntx,
               height=height, width=width,
               stored_finals=_use_stored_finals(bins, n_lights, shadows))
    return [params, taus] + arrays, cfg


class _SoftCoreFunction(torch.autograd.Function):
    """`_soft_tiled_core` as one autograd node over the tensors of (packed,
    camera, tau_d, tau_e), flattened by `runtime.graph._flatten`: the JAX
    package's custom_vjp (soft_tiled.py:2041-2169). The forward bins at the
    K caps and runs `cond(overflow, brute_fwd, tiled_fwd)`: each branch
    prepares its kernel's operands with autograd on (from detached copies
    of the leaves) and runs B6 or B4 on them. The backward runs
    `cond(overflow, brute_bwd, tiled_bwd)`: each branch runs its kernel's
    backward (B7 or B5) on the cotangent and pulls the kernel's gradients
    back through its forward branch's preparation with
    `torch.autograd.grad`, to one gradient a leaf (zeros where the branch
    does not use a leaf), so that both branches return the same tree.

    JAX's `tiled_bwd` prepares the operands again inside the backward; here
    the backward branch reuses the graph its forward branch kept, as the
    eager path does: the same flag chooses both conds, so a backward branch
    runs only where its forward branch ran. (Recomputing cost a replay of
    the 1080p train step 179 more device operations and about 0.3 ms more
    device time on an H100: scripts/torch_replay_times.py.)

    Where the bins' slot count calls for the stored-finals regime
    (`_use_stored_finals`) and a gradient is wanted, the finals block is
    allocated before the forward cond, not inside a branch (a branch's
    outputs are copied out of it, and the brute branch would have to fill a
    block of up to hundreds of MB): the tiled forward branch writes it and
    the tiled backward branch reads it; the brute branches never touch it.
    Under `run_if` (the warm-up and eager calls on the card) both branches
    launch: where the brute branch is taken, B4 returns without writing the
    block and B5 gets a zero cotangent, so its work list is empty and it
    reads no pixel of the block."""

    @staticmethod
    def forward(ctx, frame, spec, *leaves):
        packed, camera, tau_d, tau_e = _unflatten(spec, iter(leaves))
        height, width, shading, shadows, k, shadow_k = frame
        bins = _bin_soft(packed, tau_e, camera, height=height, width=width,
                         k=k, shadows=shadows, shadow_k=shadow_k)
        preps = {}
        n_lights = packed.lights.position.shape[0]
        finals = None
        if (_use_stored_finals(bins, n_lights, shadows)
                and any(ctx.needs_input_grad[2:])):
            finals = finals_block(dict(nty=bins.nty, ntx=bins.ntx,
                                       shading=shading, shadows=shadows,
                                       n_lights=n_lights), packed.device)

        def prepare(brute):
            with torch.enable_grad():
                lv = [t.detach().requires_grad_(True) for t in leaves]
                inputs, cfg = _soft_operands(brute, *_unflatten(spec, iter(lv)),
                                             bins, frame)
            preps[brute] = (lv, inputs, cfg)
            return [t.detach() for t in inputs], cfg

        def tiled_fwd(run_if=None):
            (params, taus, *tables), cfg = prepare(False)
            return soft_tiled_fwd(params, taus, tables, bins.counts, cfg=cfg,
                                  run_if=run_if, want=0, finals=finals)

        def brute_fwd(run_if=None):
            inputs, cfg = prepare(True)
            return soft_brute_fwd(*inputs, height=height, width=width,
                                  cfg=cfg, run_if=run_if, want=1)

        img = cond(bins.overflow, brute_fwd, tiled_fwd, site="soft_tiled.fwd")
        ctx.frame, ctx.bins, ctx.preps, ctx.finals = frame, bins, preps, finals
        return img

    @staticmethod
    def backward(ctx, g):
        frame, bins, preps, finals = ctx.frame, ctx.bins, ctx.preps, ctx.finals
        height, width = frame[:2]

        def branch(brute):
            def bwd(run_if=None):
                # with run_if (an eager call on the card) the branch not
                # taken gets a zero cotangent, on which B5 / B7 return zeros
                # (and B5 reads no pixel of a finals block B4 did not write)
                g_ = _select_branch(g, run_if, int(brute))
                lv, inputs, cfg = preps[brute]
                detached = [t.detach() for t in inputs]
                if brute:
                    grads = soft_brute_bwd(*detached, g_, height=height,
                                           width=width, cfg=cfg)
                else:
                    grads = soft_tiled_bwd(detached[0], detached[1],
                                           detached[2:], bins.counts, g_,
                                           cfg=cfg, finals=finals)
                used = [(t, d) for t, d in zip(inputs, grads) if t.requires_grad]
                pulled = torch.autograd.grad([t for t, _ in used], lv,
                                             [d for _, d in used],
                                             allow_unused=True)
                return tuple(torch.zeros_like(t) if d is None else d
                             for t, d in zip(lv, pulled))
            return bwd

        grads = cond(bins.overflow, branch(True), branch(False))
        ctx.preps = ctx.finals = None
        return (None, None) + grads


def _soft_tiled_core(packed, camera: Camera, tau_d, tau_e, height: int,
                     width: int, shading: str, shadows: bool, k: int,
                     shadow_k: int) -> torch.Tensor:
    """The soft frame at fixed K caps with no host read: the JAX package's
    `_soft_tiled_core` (soft_tiled.py:2041-2173), through
    `_SoftCoreFunction`. `_bin_soft` runs at the K caps and its lists may
    overflow; the tiled kernels (B4, and B5 in the backward) run where they
    do not, the brute soft kernels (B6, B7) where they do, chosen on the
    card by `runtime.graph.cond` as `lax.cond` chooses (captured, a replay
    runs only the branch taken, forward and backward). (H, W, 4) float32
    with autograd to the packed scene, the camera's tensors and both
    temperatures (device scalars the caller owns, or numbers)."""
    dev = packed.device
    leaves: list = []
    spec = _flatten((packed, camera, device_scalar(tau_d, dev),
                     device_scalar(tau_e, dev)), leaves)
    return _SoftCoreFunction.apply(
        (height, width, shading, shadows, k, shadow_k), spec, *leaves)


def render_soft_tiled(scene, camera: Camera, config: RenderConfig) -> torch.Tensor:
    """Tiled+culled soft differentiable render, the JAX package's
    `render_soft_tiled`: the lists binned at the config's K caps; where none
    overflows, the tiled soft kernels (B4 forward, B5 backward), else the
    brute soft kernels (B6, B7) for the whole frame, as JAX's `lax.cond`
    chooses. Eagerly the overflow flag is read once on the host and only
    the branch taken runs (`_soft_tiled_core` is the same function with no
    host read). Both camera families. Output float32 (H, W, 4), 0..255
    domain, with autograd to every scene leaf (and the camera's tensors)."""
    packed = scene.pack() if hasattr(scene, "pack") else scene
    h, w = config.height, config.width
    bins = _bin_soft(packed, config.tau_edge, camera, height=h, width=w,
                     k=config.cull_k, shadows=config.shadows,
                     shadow_k=config.shadow_cull_k)
    if bool(bins.overflow):
        return _soft_render_core(packed, camera, config.tau_depth,
                                 config.tau_edge, h, w, config.shading,
                                 config.shadows, camera.normalize)
    params, taus, tables, counts, cfg = soft_kernel_inputs(packed, camera,
                                                           config, bins)
    return SoftTiledFunction.apply(params, taus, *tables, counts, cfg)
