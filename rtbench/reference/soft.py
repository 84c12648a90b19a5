"""The soft differentiable frame, every pixel against every primitive, and
the fit's loss: the project's soft renderer (a SoftRas-style aggregation) as
plain PyTorch, its gradients by autograd.

Each primitive gets a smooth coverage: a sphere the sigmoid of its signed
silhouette margin (r^2 - d^2) / (2 r tau_e) times a sigmoid in-front gate;
a triangle the product of the sigmoids of its barycentric margins (in
tau_e scaled to each edge). Which primitive shows is a softmax over
-t / tau_d + log(coverage) among those with coverage above 1e-12; whether
any covers the pixel is w_bg = prod(1 - coverage). Phong, and lambert with
shadows, shade once per pixel the softmax-expected hit point, normal and
albedo; a light's soft visibility is prod(1 - occlusion) along the shadow
ray, each occluder's coverage gated to the open segment. Clipping is
min(max(x, lo), hi) with torch.maximum / torch.minimum, which split the
gradient of an exact tie in two, as the project's renderer defines it.

Nothing here culls: every pixel sees every primitive. The port's tiled frame
drops, tile by tile, primitives whose padded screen box misses the tile
(coverage below about 1.1e-7 there); where such a primitive is nearer than
what covers a pixel, the softmax over depth still gives it weight, so the
tiled frame departs from this one by a little at a few pixels, and by an
amount that depends on the tiles. The comparison that decides `correct`
takes that departure into its lower reading."""

from __future__ import annotations

import functools

import torch

from rtbench.reference.camera import rays

EPSILON = 1e-6
LEGACY_FOG_MAX = 180.0
SHADOW_OFFSET = 1e-2
SHADOW_T_MIN = 1e-3
VALID_COV = 1e-12


@functools.lru_cache(maxsize=None)
def _const(c: float, dtype, device):
    return torch.tensor(c, dtype=dtype, device=device)


def _c(c, x):
    return c if isinstance(c, torch.Tensor) else _const(float(c), x.dtype, x.device)


def tmax(x, c):
    return torch.maximum(x, _c(c, x))


def tmin(x, c):
    return torch.minimum(x, _c(c, x))


def tclip(x, lo, hi):
    return tmin(tmax(x, lo), hi)


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def sphere_soft(o, d, s, tau_e):
    """(P, S) depth, coverage and normal planes."""
    ox, oy, oz = o
    dx, dy, dz = d
    c = s["sphere_origin"]
    cx, cy, cz = c[:, 0][None, :], c[:, 1][None, :], c[:, 2][None, :]
    r = s["sphere_radius"][None, :]
    lx, ly, lz = cx - ox, cy - oy, cz - oz
    tca = lx * dx + ly * dy + lz * dz
    d2 = lx * lx + ly * ly + lz * lz - tca * tca
    r2 = r * r
    margin = (r2 - d2) / tmax(2.0 * r, 1e-6)
    cov = torch.sigmoid(margin / tau_e) * torch.sigmoid(tca / tmax(tau_e, 1e-6))
    beta = tmax(tau_e, 1e-3) * tmax(2.0 * r, 1e-6)
    thc = torch.sqrt(beta * softplus((r2 - d2) / beta) + 1e-12)
    t = tca - thc
    rpos = r > 0
    inv_r = torch.where(rpos, 1.0 / torch.where(rpos, r, torch.ones_like(r)),
                        torch.zeros_like(r))
    return t, cov, ((ox + t * dx - cx) * inv_r, (oy + t * dy - cy) * inv_r,
                    (oz + t * dz - cz) * inv_r)


def triangle_soft(o, d, s, tau_e):
    """(P, T) depth, coverage and ray-facing normal planes."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0 = s["tri_verts"][:, 0, :]
    e1 = s["tri_verts"][:, 1, :] - v0
    e2 = s["tri_verts"][:, 2, :] - v0
    v0x, v0y, v0z = (v0[:, q][None, :] for q in range(3))
    e1x, e1y, e1z = (e1[:, q][None, :] for q in range(3))
    e2x, e2y, e2z = (e2[:, q][None, :] for q in range(3))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) >= EPSILON
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    s1 = torch.sqrt(tmax(e1x * e1x + e1y * e1y + e1z * e1z, 0.0))
    s2 = torch.sqrt(tmax(e2x * e2x + e2y * e2y + e2z * e2z, 0.0))
    cov = (torch.sigmoid(u / (tau_e / tmax(s1, 1e-6)))
           * torch.sigmoid(v / (tau_e / tmax(s2, 1e-6)))
           * torch.sigmoid((1.0 - u - v) / (tau_e / tmax(0.5 * (s1 + s2), 1e-6))))
    cov = torch.where(ok, cov, torch.zeros_like(cov))
    gnx = e1y * e2z - e1z * e2y
    gny = e1z * e2x - e1x * e2z
    gnz = e1x * e2y - e1y * e2x
    gmag = torch.sqrt(tmax(gnx * gnx + gny * gny + gnz * gnz, 1e-40))
    gnx, gny, gnz = gnx / gmag, gny / gmag, gnz / gmag
    flip = torch.where(gnx * dx + gny * dy + gnz * dz > 0, -1.0, 1.0)
    return t, cov, (gnx * flip, gny * flip, gnz * flip)


def _parts(o, d, s, tau_e):
    parts = []
    if s["tri_verts"].shape[0]:
        parts.append(triangle_soft(o, d, s, tau_e) + (s["tri_colour"], "tri"))
    if s["sphere_radius"].shape[0]:
        parts.append(sphere_soft(o, d, s, tau_e) + (s["sphere_colour"], "sph"))
    return parts


def _log_unoccluded(s, so, ld, dist, tau_e, counts):
    """(P, 1) log prod(1 - occ) along the shadow rays."""
    tau_g = tmax(tau_e, 1e-4)
    shift = tmax(tau_g * 4.0, SHADOW_T_MIN)
    acc = torch.zeros_like(dist)
    for t, cov, _n, _alb, kind in _parts(so, ld, s, tau_e):
        occ = (cov * torch.sigmoid((t - shift) / tau_g)
               * torch.sigmoid((dist - t) / tau_g))
        if counts is not None:
            counts.append((f"occ_{kind}", (occ > VALID_COV).sum(-1)))
        acc = acc + torch.sum(torch.log1p(-tclip(occ, 0.0, 1.0 - 1e-6)),
                              dim=-1, keepdim=True)
    return acc


def trace(s: dict, o, d, *, shading: str, tau_d, tau_e, shadows: bool,
          counts=None):
    """(P, 3) o, d -> (P, 4) RGBA in 0..255. With a list `counts`, appends
    (name, (P,) tensor) pairs: the primitives of each kind whose coverage is
    above 1e-12 ("tri", "sph"), whether the pixel is covered
    (1 - w_bg != 0) and, per light, the occluders above 1e-12."""
    oc = tuple(o[:, q:q + 1] for q in range(3))
    dc = tuple(d[:, q:q + 1] for q in range(3))
    parts = _parts(oc, dc, s, tau_e)
    ts = torch.cat([p[0] for p in parts], dim=-1)
    covs = torch.cat([p[1] for p in parts], dim=-1)
    valid = covs > VALID_COV
    logit = torch.where(valid, -ts / tau_d + torch.log(tclip(covs, 1e-12, 1.0)),
                        torch.full_like(ts, -1e30))
    w = torch.softmax(logit, dim=-1)
    w_bg = torch.exp(torch.sum(torch.log1p(-tclip(covs, 0.0, 1.0 - 1e-6)),
                               dim=-1, keepdim=True))
    if counts is not None:
        for p in parts:
            counts.append((p[4], (p[1] > VALID_COV).sum(-1)))
        counts.append(("covered", (1.0 - w_bg[:, 0]) != 0))
    aggregate = shading == "phong" or (shadows and shading == "lambert")
    lights_pos = s["lights.position"]
    if aggregate:
        norm = [torch.cat([p[2][q] * torch.ones_like(p[0]) for p in parts], -1)
                for q in range(3)]
        albs = [torch.cat([p[3][:, q][None, :].expand_as(p[0]) for p in parts], -1)
                for q in range(3)]
        t_hat = torch.sum(w * ts, dim=-1, keepdim=True)
        nx, ny, nz = (torch.sum(w * n, dim=-1, keepdim=True) for n in norm)
        ninv = torch.rsqrt(tmax(nx * nx + ny * ny + nz * nz, 1e-20))
        nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
        ar, ag, ab = (torch.sum(w * a, dim=-1, keepdim=True) for a in albs)
        (ox, oy, oz), (dx, dy, dz) = oc, dc
        px, py, pz = ox + t_hat * dx, oy + t_hat * dy, oz + t_hat * dz
        vinv = torch.rsqrt(tmax(dx * dx + dy * dy + dz * dz, 1e-20))
        vx, vy, vz = -dx * vinv, -dy * vinv, -dz * vinv
        zero = torch.zeros_like(t_hat)
        diff = [zero, zero, zero]
        spec = [zero, zero, zero]
        for li in range(lights_pos.shape[0]):
            lp = lights_pos[li]
            lint = s["lights.intensity"][li]
            lc = s["lights.colour"][li]
            tlx, tly, tlz = lp[0] - px, lp[1] - py, lp[2] - pz
            dist = torch.sqrt(tmax(tlx * tlx + tly * tly + tlz * tlz, 1e-20))
            ldx, ldy, ldz = tlx / dist, tly / dist, tlz / dist
            ndotl = tmax(nx * ldx + ny * ldy + nz * ldz, 0.0)
            if shadows:
                so = (px + SHADOW_OFFSET * nx, py + SHADOW_OFFSET * ny,
                      pz + SHADOW_OFFSET * nz)
                vis = torch.exp(_log_unoccluded(s, so, (ldx, ldy, ldz), dist,
                                                tau_e, counts))
            else:
                vis = 1.0
            wd = lint * ndotl * vis
            diff = [diff[q] + wd * lc[q] for q in range(3)]
            if shading == "phong":
                two = 2.0 * (nx * ldx + ny * ldy + nz * ldz)
                rdotv = tmax((two * nx - ldx) * vx + (two * ny - ldy) * vy
                             + (two * nz - ldz) * vz, 0.0)
                ws = (s["lights.spec_strength"]
                      * torch.exp(s["lights.shininess"] * torch.log(tmax(rdotv, 1e-20)))
                      * lint * vis * (ndotl > 0.0))
                spec = [spec[q] + ws * lc[q] for q in range(3)]
        amb = s["lights.ambient"]
        rgb = [(1.0 - w_bg) * (a * (amb + diff[q]) + spec[q]) * 255.0
               for q, a in enumerate((ar, ag, ab))]
    else:
        shaded = [[], [], []]
        (ox, oy, oz), (dx, dy, dz) = oc, dc
        for t, cov, n, alb, _k in parts:
            a = [alb[:, q][None, :] for q in range(3)]
            if shading == "legacy":
                sc = 255.0 - (t / LEGACY_FOG_MAX) * 255.0
                for q in range(3):
                    shaded[q].append(sc * a[q])
                continue
            px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
            dr = [0.0, 0.0, 0.0]
            for li in range(lights_pos.shape[0]):
                lp = lights_pos[li]
                tlx, tly, tlz = lp[0] - px, lp[1] - py, lp[2] - pz
                rinv = torch.rsqrt(tmax(tlx * tlx + tly * tly + tlz * tlz, 1e-40))
                ndotl = tmax((n[0] * tlx + n[1] * tly + n[2] * tlz) * rinv, 0.0)
                wl = s["lights.intensity"][li] * ndotl
                dr = [dr[q] + wl * s["lights.colour"][li][q] for q in range(3)]
            for q in range(3):
                shaded[q].append(a[q] * (s["lights.ambient"] + dr[q]) * 255.0)
        rgb = [(1.0 - w_bg) * torch.sum(w * torch.cat(shaded[q], -1), dim=-1,
                                        keepdim=True) for q in range(3)]
    rgb = torch.cat(rgb, dim=-1)
    if shading != "legacy":
        rgb = tclip(rgb, 0.0, 255.0)
    alpha = torch.full(rgb.shape[:-1] + (1,), 255.0, dtype=rgb.dtype,
                       device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)


def block_rows(width: int, n_prims: int, budget: int = 1 << 24) -> int:
    """Rows a block: about `budget` (pixel, primitive) elements a plane."""
    return max(1, min(1 << 12, budget // max(1, width * max(n_prims, 1))))


def n_prims(s: dict) -> int:
    return int(s["tri_verts"].shape[0] + s["sphere_radius"].shape[0])


def render(s: dict, cam: dict, height: int, width: int, *, shading: str,
           shadows: bool, tau_d: float, tau_e: float, dtype=torch.float32,
           rows=None, counts: bool = False):
    """The soft frame's rows `rows` (a slice; all by default) as (R, W, 4)
    RGBA in `dtype`, in blocks of rows.
    With `counts`, also a dict of (R, W) per-pixel counts (see `trace`),
    with no gradient."""
    dev = s["sphere_origin"].device
    rows = rows or slice(0, height)
    sd = {k: v.to(dtype) for k, v in s.items()}
    td = torch.tensor(tau_d, dtype=dtype, device=dev)
    te = torch.tensor(tau_e, dtype=dtype, device=dev)
    step = block_rows(width, n_prims(s))
    out, cnt = [], []
    for r0 in range(rows.start, rows.stop, step):
        r1 = min(r0 + step, rows.stop)
        o, d = rays(cam, slice(r0, r1), width, dev, dtype)
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        if counts:
            c = []
            with torch.no_grad():
                img = trace(sd, o, d, shading=shading, tau_d=td, tau_e=te,
                            shadows=shadows, counts=c)
            cnt.append(_merge(c, r1 - r0, width))
        else:
            img = trace(sd, o, d, shading=shading, tau_d=td, tau_e=te,
                        shadows=shadows)
        out.append(img.reshape(r1 - r0, width, 4))
    img = torch.cat(out)
    if not counts:
        return img
    return img, {k: torch.cat([c[k] for c in cnt]) for k in cnt[0]}


def _merge(pairs, h, w):
    """Sum the (name, (P,) tensor) pairs by name into (h, w) planes."""
    out = {}
    for name, v in pairs:
        v = v.reshape(h, w)
        out[name] = out[name] + v if name in out else v
    return out
