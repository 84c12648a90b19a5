"""Soft differentiable renderer (SoftRas-style aggregation), in torch ops.

The independent oracle of the tiled soft kernels: every formula is the JAX
package's `diff/soft.py`, written in plain torch so that autograd gives its
gradients.

- every primitive gets a smooth COVERAGE in [0, 1] instead of a binary hit:
  * sphere: sigmoid of the signed silhouette margin (r^2 - d^2)/tau_e,
    gated by a smooth in-front indicator sigmoid(tca/tau_e);
  * triangle: product of sigmoids of the barycentric margins u, v, 1-u-v
    (in units of tau_e scaled to barycentric space);
- visibility is a softmin over depth: primitive weights
    w_i ∝ cov_i * exp(-t_i / tau_d)
  normalized together with a background term, so w -> one-hot nearest-hit
  as tau -> 0;
- the pixel colour is the weight-averaged per-primitive shaded colour, or
  (phong, and lambert with soft shadows) one shading of the aggregated hit
  attributes.

Clipping is min(max(x, lo), hi) with `torch.maximum`/`torch.minimum`, never
`torch.clamp`: at an exact tie (a sigmoid saturated to 1.0, a zero
coverage) JAX's clip and maximum split the gradient evenly between the two
sides, and so do torch.maximum/minimum, while torch.clamp passes all of it.
Layout is planar: (pixels, prims) planes with the xyz components unrolled,
as in the JAX package.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from opencl_ray_tracer_tpu_torch.camera import Camera
from opencl_ray_tracer_tpu_torch.config import RenderConfig
from opencl_ray_tracer_tpu_torch.ops.intersect import EPSILON
from opencl_ray_tracer_tpu_torch.ops.shading import LEGACY_FOG_MAX
from opencl_ray_tracer_tpu_torch.runtime.graph import device_const

BG_DEPTH = 1000.0  # background pseudo-depth for the softmin aggregation

# Soft-shadow constants. The hard path offsets shadow origins 1e-2 along the
# normal and requires t > 1e-3; the soft gate keeps those semantics as
# tau_e -> 0 but widens the self-occlusion exclusion to ~4*tau_e so a
# surface's own primitive (at t ~ 0) cannot half-shadow it through the
# sigmoid tail.
SHADOW_OFFSET = 1e-2
SHADOW_T_MIN = 1e-3


def _const_like(c, x):
    """A number as a tensor of x's dtype on x's device: for float32, the
    per-device constant of runtime/graph.py (no host copy per call, so a CUDA
    graph can capture the soft paths)."""
    if isinstance(c, torch.Tensor):
        return c
    if x.dtype == torch.float32:
        return device_const(c, x.device)
    return torch.as_tensor(c, dtype=x.dtype, device=x.device)


def tmax(x, c):
    """max(x, c) with JAX's tie rule (half the gradient to each side)."""
    return torch.maximum(x, _const_like(c, x))


def tmin(x, c):
    return torch.minimum(x, _const_like(c, x))


def tclip(x, lo, hi):
    """jnp.clip: min(max(x, lo), hi), ties split as in JAX."""
    return tmin(tmax(x, lo), hi)


def softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _sphere_soft_planar(o, d, scene, tau_e):
    """(P, S) soft depth + coverage + unit-ish normals for spheres.

    o, d: 3-tuples of (P, 1) pixel columns. Returns (t, cov, n) with n a
    3-tuple of (P, S) planes."""
    ox, oy, oz = o
    dx, dy, dz = d
    c = scene.sphere_origin
    cx, cy, cz = c[:, 0][None, :], c[:, 1][None, :], c[:, 2][None, :]
    r = scene.sphere_radius[None, :]
    lx, ly, lz = cx - ox, cy - oy, cz - oz
    tca = lx * dx + ly * dy + lz * dz
    d2 = lx * lx + ly * ly + lz * lz - tca * tca
    r2 = r * r
    margin = (r2 - d2) / tmax(2.0 * r, 1e-6)
    cov = torch.sigmoid(margin / tau_e) * torch.sigmoid(tca / tmax(tau_e, 1e-6))
    # t = tca - sqrt(r^2 - d^2) with a tau-scaled softplus floor in place of
    # a clamp: exact in the interior, smooth and bounded at the silhouette.
    q = r2 - d2
    beta = tmax(tau_e, 1e-3) * tmax(2.0 * r, 1e-6)
    thc = torch.sqrt(beta * softplus(q / beta) + 1e-12)
    t = tca - thc
    rpos = r > 0
    inv_r = torch.where(rpos, 1.0 / torch.where(rpos, r, torch.ones_like(r)),
                        torch.zeros_like(r))
    nx = (ox + t * dx - cx) * inv_r
    ny = (oy + t * dy - cy) * inv_r
    nz = (oz + t * dz - cz) * inv_r
    return t, cov, (nx, ny, nz)


def _tri_soft_planar(o, d, scene, tau_e):
    """(P, T) soft depth + coverage + ray-facing normals for triangles."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0 = scene.tri_verts[:, 0, :]
    e1 = scene.tri_verts[:, 1, :] - v0
    e2 = scene.tri_verts[:, 2, :] - v0
    v0x, v0y, v0z = (v0[:, q][None, :] for q in range(3))
    e1x, e1y, e1z = (e1[:, q][None, :] for q in range(3))
    e2x, e2y, e2z = (e2[:, q][None, :] for q in range(3))

    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_ok = torch.abs(det) >= EPSILON
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det

    s1 = torch.sqrt(tmax(e1x * e1x + e1y * e1y + e1z * e1z, 0.0))
    s2 = torch.sqrt(tmax(e2x * e2x + e2y * e2y + e2z * e2z, 0.0))
    tau_u = tau_e / tmax(s1, 1e-6)
    tau_v = tau_e / tmax(s2, 1e-6)
    tau_w = tau_e / tmax(0.5 * (s1 + s2), 1e-6)
    cov = (
        torch.sigmoid(u / tau_u)
        * torch.sigmoid(v / tau_v)
        * torch.sigmoid((1.0 - u - v) / tau_w)
    )
    cov = torch.where(det_ok, cov, torch.zeros_like(cov))

    gnx = e1y * e2z - e1z * e2y
    gny = e1z * e2x - e1x * e2z
    gnz = e1x * e2y - e1y * e2x
    gmag = torch.sqrt(tmax(gnx * gnx + gny * gny + gnz * gnz, 1e-40))
    gnx, gny, gnz = gnx / gmag, gny / gmag, gnz / gmag
    ndotd = gnx * dx + gny * dy + gnz * dz
    flip = torch.where(ndotd > 0, -1.0, 1.0)
    return t, cov, (gnx * flip, gny * flip, gnz * flip)


def _shade_planar(scene, o, d, t, n, albedo, shading):
    """Per-(pixel, prim) shaded RGB planes in the 0..255 domain."""
    ar = albedo[:, 0][None, :]
    ag = albedo[:, 1][None, :]
    ab = albedo[:, 2][None, :]
    if shading == "legacy":
        s = 255.0 - (t / LEGACY_FOG_MAX) * 255.0
        return s * ar, s * ag, s * ab
    if shading == "lambert":
        ox, oy, oz = o
        dx, dy, dz = d
        nx, ny, nz = n
        lights = scene.lights
        px = ox + t * dx
        py = oy + t * dy
        pz = oz + t * dz
        diff_r = diff_g = diff_b = 0.0
        for li in range(lights.position.shape[0]):
            lp = lights.position[li]
            tlx, tly, tlz = lp[0] - px, lp[1] - py, lp[2] - pz
            tl2 = tmax(tlx * tlx + tly * tly + tlz * tlz, 1e-40)
            rinv = torch.rsqrt(tl2)
            ndotl = tmax((nx * tlx + ny * tly + nz * tlz) * rinv, 0.0)
            w = lights.intensity[li] * ndotl
            lc = lights.colour[li]
            diff_r = diff_r + w * lc[0]
            diff_g = diff_g + w * lc[1]
            diff_b = diff_b + w * lc[2]
        amb = lights.ambient
        return (
            ar * (amb + diff_r) * 255.0,
            ag * (amb + diff_g) * 255.0,
            ab * (amb + diff_b) * 255.0,
        )
    raise ValueError(f"soft shading mode {shading!r} not supported (legacy/lambert)")


def _occlusion_logvis(scene, so, ld, dist, tau_e):
    """Log soft visibility of a light along shadow rays: (P, 1)
    log prod_j (1 - occ_j), occ_j = coverage of occluder j gated to the
    open segment (SHADOW_T_MIN..dist) by tau_e-temperature sigmoids."""
    tau_g = tmax(tau_e, 1e-4)
    shift = tmax(tau_g * 4.0, SHADOW_T_MIN)
    acc = torch.zeros_like(dist)
    parts = []
    if scene.num_triangles:
        parts.append(_tri_soft_planar(so, ld, scene, tau_e))
    if scene.num_spheres:
        parts.append(_sphere_soft_planar(so, ld, scene, tau_e))
    for t, cov, _n in parts:
        occ = (
            cov
            * torch.sigmoid((t - shift) / tau_g)
            * torch.sigmoid((dist - t) / tau_g)
        )
        acc = acc + torch.sum(
            torch.log1p(-tclip(occ, 0.0, 1.0 - 1e-6)), dim=-1, keepdim=True
        )
    return acc


def _shade_aggregate(scene, o, d, ts, covs, normals, albs, tau_d, tau_e,
                     *, phong: bool, shadows: bool):
    """Shade-after-aggregate: softmax-expected hit point/normal/albedo, then
    one shading evaluation per pixel with soft shadows + optional Phong
    specular. Returns a 3-tuple of (P, 1) UNclipped 0..255-domain channels."""
    ox, oy, oz = o
    dx, dy, dz = d
    valid = covs > 1e-12
    logit = torch.where(
        valid, -ts / tau_d + torch.log(tclip(covs, 1e-12, 1.0)),
        torch.full_like(ts, -1e30),
    )
    w = torch.softmax(logit, dim=-1)
    w_bg = torch.exp(torch.sum(
        torch.log1p(-tclip(covs, 0.0, 1.0 - 1e-6)), dim=-1, keepdim=True))
    t_hat = torch.sum(w * ts, dim=-1, keepdim=True)
    nx = torch.sum(w * normals[0], dim=-1, keepdim=True)
    ny = torch.sum(w * normals[1], dim=-1, keepdim=True)
    nz = torch.sum(w * normals[2], dim=-1, keepdim=True)
    ninv = torch.rsqrt(tmax(nx * nx + ny * ny + nz * nz, 1e-20))
    nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
    ar = torch.sum(w * albs[0], dim=-1, keepdim=True)
    ag = torch.sum(w * albs[1], dim=-1, keepdim=True)
    ab = torch.sum(w * albs[2], dim=-1, keepdim=True)
    px = ox + t_hat * dx
    py = oy + t_hat * dy
    pz = oz + t_hat * dz

    vinv = torch.rsqrt(tmax(dx * dx + dy * dy + dz * dz, 1e-20))
    vx, vy, vz = -dx * vinv, -dy * vinv, -dz * vinv

    lights = scene.lights
    zero = torch.zeros_like(t_hat)
    diff_r, diff_g, diff_b = zero, zero, zero
    spec_r, spec_g, spec_b = zero, zero, zero
    for li in range(lights.position.shape[0]):
        lp = lights.position[li]
        lint = lights.intensity[li]
        lc = lights.colour[li]
        tlx, tly, tlz = lp[0] - px, lp[1] - py, lp[2] - pz
        dist = torch.sqrt(tmax(tlx * tlx + tly * tly + tlz * tlz, 1e-20))
        ldx, ldy, ldz = tlx / dist, tly / dist, tlz / dist
        ndotl = tmax(nx * ldx + ny * ldy + nz * ldz, 0.0)
        if shadows:
            so = (px + SHADOW_OFFSET * nx,
                  py + SHADOW_OFFSET * ny,
                  pz + SHADOW_OFFSET * nz)
            vis = torch.exp(
                _occlusion_logvis(scene, so, (ldx, ldy, ldz), dist, tau_e))
        else:
            vis = 1.0
        wd = lint * ndotl * vis
        diff_r = diff_r + wd * lc[0]
        diff_g = diff_g + wd * lc[1]
        diff_b = diff_b + wd * lc[2]
        if phong:
            two_ndl = 2.0 * (nx * ldx + ny * ldy + nz * ldz)
            rx = two_ndl * nx - ldx
            ry = two_ndl * ny - ldy
            rz = two_ndl * nz - ldz
            rdotv = tmax(rx * vx + ry * vy + rz * vz, 0.0)
            ws = (
                lights.spec_strength
                * torch.exp(lights.shininess * torch.log(tmax(rdotv, 1e-20)))
                * lint
                * vis
                * (ndotl > 0.0)
            )
            spec_r = spec_r + ws * lc[0]
            spec_g = spec_g + ws * lc[1]
            spec_b = spec_b + ws * lc[2]

    amb = lights.ambient
    fg = (
        ar * (amb + diff_r) + spec_r,
        ag * (amb + diff_g) + spec_g,
        ab * (amb + diff_b) + spec_b,
    )
    return tuple((1.0 - w_bg) * c * 255.0 for c in fg)


def _soft_aggregate_planar(ts, covs, shade_rgb, tau_d, bg_rgb):
    """Softmin-over-depth aggregation with a coverage-composited background:
    WHICH primitive is visible is a softmax over -t/tau_d + log cov among
    valid (cov > 1e-12) primitives; WHETHER any covers the pixel is
    w_bg = prod_i (1 - cov_i). Returns a 3-tuple of (P, 1)."""
    valid = covs > 1e-12
    logit = torch.where(
        valid, -ts / tau_d + torch.log(tclip(covs, 1e-12, 1.0)),
        torch.full_like(ts, -1e30),
    )
    w = torch.softmax(logit, dim=-1)
    w_bg = torch.exp(torch.sum(
        torch.log1p(-tclip(covs, 0.0, 1.0 - 1e-6)), dim=-1, keepdim=True))
    out = []
    for c in range(3):
        fg = torch.sum(w * shade_rgb[c], dim=-1, keepdim=True)
        out.append(w_bg * bg_rgb[c] + (1.0 - w_bg) * fg)
    return out


def trace_soft(scene, o, d, *, shading: str, tau_d, tau_e,
               shadows: bool = False):
    """Soft-trace ray bundles -> float RGBA (0..255 domain).

    o: (..., 3) origins; d: (..., 3) or broadcastable directions. legacy and
    lambert-without-shadows shade per primitive then aggregate; phong, and
    lambert with shadows, aggregate the hit attributes first and shade once
    per pixel (_shade_aggregate)."""
    lead = o.shape[:-1]
    d_b = torch.broadcast_to(d, lead + (3,))
    oc = tuple(o[..., q].reshape(-1, 1) for q in range(3))
    dc = tuple(d_b[..., q].reshape(-1, 1) for q in range(3))

    aggregate_shading = shading == "phong" or (shadows and shading == "lambert")

    parts_t, parts_cov = [], []
    parts_rgb = ([], [], [])
    parts_n = ([], [], [])
    parts_a = ([], [], [])

    def add(t, cov, n, colour):
        parts_t.append(t)
        parts_cov.append(cov)
        if aggregate_shading:
            like = torch.ones_like(t)
            for q in range(3):
                parts_n[q].append(n[q] * like)
                parts_a[q].append(colour[:, q][None, :] * like)
        else:
            for q, s in enumerate(_shade_planar(scene, oc, dc, t, n, colour,
                                                shading)):
                parts_rgb[q].append(s)

    if scene.num_triangles:
        t, cov, n = _tri_soft_planar(oc, dc, scene, tau_e)
        add(t, cov, n, scene.tri_colour)
    if scene.num_spheres:
        t, cov, n = _sphere_soft_planar(oc, dc, scene, tau_e)
        add(t, cov, n, scene.sphere_colour)

    ts = torch.cat(parts_t, dim=-1)
    covs = torch.cat(parts_cov, dim=-1)

    if aggregate_shading:
        rgb = _shade_aggregate(
            scene, oc, dc, ts, covs,
            tuple(torch.cat(p, -1) for p in parts_n),
            tuple(torch.cat(p, -1) for p in parts_a),
            tau_d, tau_e, phong=shading == "phong", shadows=shadows,
        )
    else:
        shade = tuple(torch.cat(p, dim=-1) for p in parts_rgb)
        rgb = _soft_aggregate_planar(ts, covs, shade, tau_d, (0.0, 0.0, 0.0))

    rgb = torch.cat(rgb, dim=-1)
    if shading != "legacy":
        rgb = tclip(rgb, 0.0, 255.0)
    alpha = torch.full(rgb.shape[:-1] + (1,), 255.0, dtype=torch.float32,
                       device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1).reshape(lead + (4,))


def render_soft_jit(scene, camera: Camera, tau_d, tau_e, height: int,
                    width: int, shading: str = "lambert",
                    shadows: bool = False, row_chunk: int = 16,
                    remat: bool = True) -> torch.Tensor:
    """Row-chunked soft render. Under autograd each chunk is checkpointed
    (`remat`): only its rays are kept, and its (pixels x prims) planes are
    recomputed in the backward (a CUDA graph captures the checkpoint and
    its recompute: the compiled train step on backend "xla"). Named after
    the JAX function it ports."""
    o, d = camera.rays(height, width)

    def do_chunk(oc, dc):
        return trace_soft(scene, oc, dc, shading=shading, tau_d=tau_d,
                          tau_e=tau_e, shadows=shadows)

    rows = []
    for r0 in range(0, height, row_chunk):
        oc, dc = o[r0:r0 + row_chunk], d[r0:r0 + row_chunk]
        if remat and torch.is_grad_enabled():
            rows.append(checkpoint(do_chunk, oc, dc, use_reentrant=False))
        else:
            rows.append(do_chunk(oc, dc))
    return torch.cat(rows, dim=0)


def render_soft(scene, camera: Camera, config: RenderConfig) -> torch.Tensor:
    """Soft differentiable render -> float32 (H, W, 4), 0..255 domain, on
    the scene's device. Legacy depth-fog, lambert and phong (with soft
    shadows when config.shadows) are all differentiable."""
    dev = scene.device
    return render_soft_jit(
        scene, camera,
        device_const(config.tau_depth, dev), device_const(config.tau_edge, dev),
        height=config.height, width=config.width,
        shading=config.shading, shadows=config.shadows,
    )
