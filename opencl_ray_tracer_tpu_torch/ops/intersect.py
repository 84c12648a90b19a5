"""Vectorised ray-primitive intersection ops (plain torch, any device).

Reproduces the reference's exact hit semantics, with every branch written as
a select (rayTracer.cl:54-97):

- Sphere: geometric method (rayTracer.cl:80-109). QUIRKS preserved:
  * miss returns 0.0 (not -1), so a true hit at exactly t=0 is discarded by
    the caller's `distance == 0.0f -> continue` (rayTracer.cl:176-177);
  * tca < 0 (center behind origin) => miss;
  * returns t0 = tca - thc which may be NEGATIVE for origins inside the
    sphere — and a negative t WINS the nearest-hit min (no lower clamp).
- Triangle: Möller–Trumbore with EPSILON=1e-6 (rayTracer.cl:37-78). QUIRK:
  t is unconstrained — triangles BEHIND the origin (t<0) count as hits and
  win the min, exactly as in the reference.
- Nearest hit: running min initialised to 300000.0 (rayTracer.cl:136-137);
  cubes processed before spheres, sphere wins ties only strictly
  (`distance < closest`, rayTracer.cl:179), triangle ties go to the earliest
  triangle (strict `t < closest`, rayTracer.cl:162).

All functions broadcast over arbitrary leading pixel dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EPSILON = 1e-6          # rayTracer.cl:4
MISS_T = 300000.0       # rayTracer.cl:137 sentinel
SHADOW_EPS = 1e-3


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def intersect_spheres(o, d, centers, radii):
    """Sphere hit distances with the reference's 0.0-miss sentinel.

    o: (..., 3) origins; d: (..., 3) or (3,) directions;
    centers: (S, 3); radii: (S,). Returns t: (..., S).
    """
    o = o[..., None, :]                       # (..., 1, 3)
    d = d.expand(o.shape[:-2] + (3,))[..., None, :]
    L = centers - o                           # (..., S, 3)
    tca = torch.sum(L * d, dim=-1)            # (..., S)
    d2 = torch.sum(L * L, dim=-1) - tca * tca
    r2 = radii * radii
    # sqrt argument clamped for the miss lanes (result discarded there).
    thc = torch.sqrt(torch.clamp(r2 - d2, min=0.0))
    t0 = tca - thc
    hit = (tca >= 0.0) & (d2 <= r2)
    return torch.where(hit, t0, torch.zeros_like(t0))


def intersect_tris(o, d, v0, e1, e2):
    """Möller–Trumbore over a triangle array.

    o: (..., 3); d: (..., 3) or (3,); v0/e1/e2: (T, 3) with e1 = v1 - v0,
    e2 = v2 - v0. Returns (t, valid): (..., T) each.
    """
    o = o[..., None, :]                               # (..., 1, 3)
    d = d.expand(o.shape[:-2] + (3,))[..., None, :]

    pvec = _cross(d, e2)                              # (..., T, 3)
    det = torch.sum(e1 * pvec, dim=-1)                # (..., T)
    det_ok = torch.abs(det) >= EPSILON
    # Guard the reciprocal on dead lanes; result is masked out by det_ok.
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))

    tvec = o - v0                                     # (..., T, 3)
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = _cross(tvec, e1)
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det

    valid = det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, valid


class Hit(NamedTuple):
    """Nearest-hit result over all primitives for each pixel."""

    t: torch.Tensor        # (...,) distance, MISS_T when nothing hit
    colour: torch.Tensor   # (..., 4) winning primitive RGBA (black RGBA on miss)
    normal: torch.Tensor   # (..., 3) outward normal flipped against the ray
    hit: torch.Tensor      # (...,) bool
    point: torch.Tensor    # (..., 3) hit position o + t*d


def nearest_hit(o, d, scene) -> Hit:
    """Full nearest-hit resolution with reference ordering semantics.

    scene: a Scene (unpacked layout). Broadcasts over leading dims of o.
    """
    lead = o.shape[:-1]
    d_b = d.expand(lead + (3,))
    dev = o.device

    best_t = torch.full(lead, MISS_T, dtype=torch.float32, device=dev)
    best_colour = torch.zeros(lead + (4,), dtype=torch.float32, device=dev)
    best_normal = torch.zeros(lead + (3,), dtype=torch.float32, device=dev)

    # --- cubes first (rayTracer.cl:140-169) ---
    if scene.num_triangles:
        v0 = scene.tri_verts[:, 0, :]
        e1 = scene.tri_verts[:, 1, :] - v0
        e2 = scene.tri_verts[:, 2, :] - v0
        t, valid = intersect_tris(o, d, v0, e1, e2)
        t = torch.where(valid, t, torch.full_like(t, MISS_T))
        # First minimal index == loop order tie-break (strict <).
        t_tri, idx = torch.min(t, dim=-1)
        tri_won = t_tri < best_t
        best_t = torch.where(tri_won, t_tri, best_t)
        best_colour = torch.where(
            tri_won[..., None], scene.tri_colour[idx], best_colour
        )
        n = _cross(e1, e2)
        n = n / torch.clamp(
            torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-20
        )
        n_hit = n[idx]                                  # (..., 3)
        # Flip toward the ray origin side.
        n_hit = torch.where(
            torch.sum(n_hit * d_b, dim=-1, keepdim=True) > 0, -n_hit, n_hit
        )
        best_normal = torch.where(tri_won[..., None], n_hit, best_normal)

    # --- spheres second, strict < (rayTracer.cl:172-184) ---
    if scene.num_spheres:
        ts = intersect_spheres(o, d, scene.sphere_origin, scene.sphere_radius)
        ts = torch.where(ts == 0.0, torch.full_like(ts, MISS_T), ts)
        t_sph, sidx = torch.min(ts, dim=-1)
        sph_won = t_sph < best_t
        best_t = torch.where(sph_won, t_sph, best_t)
        best_colour = torch.where(
            sph_won[..., None], scene.sphere_colour[sidx], best_colour
        )
        centre = scene.sphere_origin[sidx]              # (..., 3)
        radius = scene.sphere_radius[sidx][..., None]
        p = o + t_sph[..., None] * d_b
        ns = (p - centre) / torch.clamp(radius, min=1e-20)
        best_normal = torch.where(sph_won[..., None], ns, best_normal)

    hit = best_t < MISS_T
    point = o + best_t[..., None] * d_b
    return Hit(t=best_t, colour=best_colour, normal=best_normal, hit=hit,
               point=point)


def any_hit(o, d, scene, t_max):
    """Occlusion query for shadow rays: does anything lie in (eps, t_max)?

    o: (..., 3) shadow-ray origins; d: (..., 3) normalised directions;
    t_max: (...,) distance to the light. Returns bool (...,).
    """
    occluded = torch.zeros(o.shape[:-1], dtype=torch.bool, device=o.device)

    if scene.num_triangles:
        v0 = scene.tri_verts[:, 0, :]
        e1 = scene.tri_verts[:, 1, :] - v0
        e2 = scene.tri_verts[:, 2, :] - v0
        t, valid = intersect_tris(o, d, v0, e1, e2)
        blocked = valid & (t > SHADOW_EPS) & (t < t_max[..., None])
        occluded = occluded | torch.any(blocked, dim=-1)

    if scene.num_spheres:
        ts = intersect_spheres(o, d, scene.sphere_origin, scene.sphere_radius)
        blocked = (ts != 0.0) & (ts > SHADOW_EPS) & (ts < t_max[..., None])
        occluded = occluded | torch.any(blocked, dim=-1)

    return occluded
