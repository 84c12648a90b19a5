"""Per-frame preparation shared by the forward kernels (plain torch).

This module holds the parameter-vector layout and the per-primitive
coefficient prep that the tiled kernel (kernels/fwd_tiled.py) consumes. The
JAX package's brute-force megakernel, which also lives in its `fwd.py`, is
not ported yet (ROADMAP B3): the port's eager K escalation means the tiled
kernel never overflows, so the brute kernel is not on the main path.
"""

from __future__ import annotations

import torch

from opencl_ray_tracer_tpu_torch.camera import Camera
from opencl_ray_tracer_tpu_torch.ops.intersect import EPSILON

# params vector layout: camera affine bundle + material + lights.
_P_O0, _P_DOX, _P_DOY, _P_D0, _P_DDX, _P_DDY = 0, 3, 6, 9, 12, 15
_P_AMBIENT, _P_SPEC, _P_SHINE = 18, 19, 20
_P_LIGHTS = 21  # then per light: pos(3) colour(3) intensity(1)
_LIGHT_STRIDE = 7


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _prep_scene_arrays(packed):
    """PackedScene -> kernel operand arrays (differentiable).

    tri geometry: (9, Tp) rows [v0(3), e1(3), e2(3)]
    tri attrs:    (Tp, 8) rows [r, g, b, nx, ny, nz, 0, 0] (unit normals)
    sph geometry: (4, Sp) rows [cx, cy, cz, rad]
    sph attrs:    (Sp, 8) rows [r, g, b, cx, cy, cz, 1/rad, 1]
    (1/rad, not rad: the kernels rebuild sphere normals as (p - c) * irad;
    padded radius-0 spheres store 0.)
    """
    dev = packed.device
    tri_geo = torch.cat([packed.tri_v0, packed.tri_e1, packed.tri_e2], dim=0)
    n = _cross(packed.tri_e1.T, packed.tri_e2.T)  # (Tp, 3)
    n = n / torch.clamp(
        torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-20
    )
    tp = packed.padded_tris
    tri_attr = torch.cat(
        [packed.tri_colour.T[:, :3], n,
         torch.zeros((tp, 2), dtype=torch.float32, device=dev)],
        dim=1,
    )

    sph_geo = torch.cat([packed.sph_origin, packed.sph_radius], dim=0)
    sp = packed.padded_spheres
    rad = packed.sph_radius.T
    irad = torch.where(
        rad > 0, 1.0 / torch.where(rad > 0, rad, torch.ones_like(rad)),
        torch.zeros_like(rad),
    )
    sph_attr = torch.cat(
        [
            packed.sph_colour.T[:, :3],
            packed.sph_origin.T,
            irad,
            torch.ones((sp, 1), dtype=torch.float32, device=dev),
        ],
        dim=1,
    )
    return tri_geo, tri_attr, sph_geo, sph_attr


def _prep_affine_coefs(packed, camera: Camera):
    """Per-primitive affine/quadratic coefficients for shared-dir cameras.

    With direction d fixed and origin(x, y) = o0 + x*dox + y*doy:
      triangle (Möller–Trumbore): pvec, det, inv_det are per-triangle
      constants, and u, v, t are affine in (x, y);
      sphere: tca is affine, d^2 = |L|^2 - tca^2 is quadratic in (x, y).
    Returns tri_coef (9, Tp) rows [u0,ux,uy, v0,vx,vy, t0,tx,ty] and
    sph_coef (10, Sp) rows [tca0,tcax,tcay, d20,d2x,d2y,d2xx,d2yy,d2xy, r2].
    det-validity and zero-padding fold into u0 = -1e9 (never valid).
    """
    d = camera.d0
    o0, dox, doy = camera.o0, camera.dox, camera.doy

    v0 = packed.tri_v0.T  # (Tp, 3)
    e1 = packed.tri_e1.T
    e2 = packed.tri_e2.T
    pvec = _cross(d, e2)
    det = torch.sum(e1 * pvec, -1)
    det_ok = torch.abs(det) >= EPSILON
    inv = torch.where(
        det_ok, 1.0 / torch.where(det_ok, det, torch.ones_like(det)),
        torch.zeros_like(det),
    )
    base = o0 - v0  # (Tp, 3)
    u0 = torch.sum(base * pvec, -1) * inv
    ux = torch.sum(dox * pvec, -1) * inv
    uy = torch.sum(doy * pvec, -1) * inv
    q0 = _cross(base, e1)
    qx = _cross(dox, e1)
    qy = _cross(doy, e1)
    v0c = torch.sum(d * q0, -1) * inv
    vx = torch.sum(d * qx, -1) * inv
    vy = torch.sum(d * qy, -1) * inv
    t0c = torch.sum(e2 * q0, -1) * inv
    tx = torch.sum(e2 * qx, -1) * inv
    ty = torch.sum(e2 * qy, -1) * inv
    u0 = torch.where(det_ok, u0, torch.full_like(u0, -1e9))
    tri_coef = torch.stack([u0, ux, uy, v0c, vx, vy, t0c, tx, ty], 0)

    C = packed.sph_origin.T  # (Sp, 3)
    r = packed.sph_radius[0]
    sp = C.shape[0]
    a = torch.sum(dox * d)  # scalars
    b = torch.sum(doy * d)
    L0 = C - o0
    tca0 = torch.sum(L0 * d, -1)
    m0 = torch.sum(L0 * L0, -1)
    mx = -2.0 * torch.sum(L0 * dox, -1)
    my = -2.0 * torch.sum(L0 * doy, -1)
    mxx = torch.sum(dox * dox)
    myy = torch.sum(doy * doy)
    mxy = 2.0 * torch.sum(dox * doy)
    # d2 = m - tca^2 with tca = tca0 - a*x - b*y
    d20 = m0 - tca0 * tca0
    d2x = mx + 2.0 * tca0 * a
    d2y = my + 2.0 * tca0 * b
    sph_coef = torch.stack(
        [
            tca0,
            (-a).expand(sp),
            (-b).expand(sp),
            d20, d2x, d2y,
            (mxx - a * a).expand(sp),
            (myy - b * b).expand(sp),
            (mxy - 2.0 * a * b).expand(sp),
            r * r,
        ],
        0,
    )
    return tri_coef, sph_coef


def _camera_params(camera: Camera, lights) -> torch.Tensor:
    """(21 + 7L,) float32 params: camera bundle, material, then per light
    position(3), colour(3), intensity(1) — the `_P_*` layout."""
    parts = [
        camera.o0, camera.dox, camera.doy, camera.d0, camera.ddx, camera.ddy,
        torch.stack([lights.ambient, lights.spec_strength, lights.shininess]),
    ]
    for li in range(lights.position.shape[0]):
        parts.append(lights.position[li])
        parts.append(lights.colour[li])
        parts.append(lights.intensity[li : li + 1])
    return torch.cat([p.to(torch.float32) for p in parts])
