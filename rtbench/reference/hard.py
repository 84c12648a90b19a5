"""The hard frame, brute force over every primitive (the reference app's
rayTracer.cl semantics, with the project's lambert / phong shading and hard
shadows).

Sphere: the geometric test, a miss returns 0 and a hit at t = 0 is dropped,
tca < 0 misses, a negative t0 (origin inside) wins. Triangle: Moller-Trumbore
with EPSILON 1e-6, t unconstrained. Nearest hit: running minimum from
300000, triangles first, spheres win only strictly, ties to the earliest
triangle. Shadows: one ray a light from the hit point offset 1e-2 along the
normal, any hit in (1e-3, distance to the light). Colours in 0..255; the
packed word is R | G << 8 | B << 16 | 255 << 24 of the channels clamped to
[0, 255] and truncated."""

from __future__ import annotations

import torch

from rtbench.reference.camera import rays

EPSILON = 1e-6
MISS_T = 300000.0
SHADOW_EPS = 1e-3
SHADOW_OFFSET = 1e-2
LEGACY_FOG_MAX = 180.0
ALPHA_BITS = -16777216  # 0xFF000000 as int32


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _spheres(o, d, centres, radii):
    """(..., S) hit distances, 0 for a miss."""
    L = centres - o[..., None, :]
    dd = d[..., None, :]
    tca = torch.sum(L * dd, dim=-1)
    d2 = torch.sum(L * L, dim=-1) - tca * tca
    r2 = radii * radii
    thc = torch.sqrt(torch.clamp(r2 - d2, min=0.0))
    hit = (tca >= 0.0) & (d2 <= r2)
    return torch.where(hit, tca - thc, torch.zeros_like(tca))


def _triangles(o, d, v0, e1, e2):
    """((..., T) t, (..., T) valid)."""
    oo, dd = o[..., None, :], d[..., None, :]
    pvec = _cross(dd, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    ok = torch.abs(det) >= EPSILON
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = oo - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv
    qvec = _cross(tvec, e1)
    v = torch.sum(dd * qvec, dim=-1) * inv
    t = torch.sum(e2 * qvec, dim=-1) * inv
    return t, ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)


def _tri_edges(s):
    v0 = s["tri_verts"][:, 0, :]
    return v0, s["tri_verts"][:, 1, :] - v0, s["tri_verts"][:, 2, :] - v0


def nearest(o, d, s):
    """(t, colour (..., 4), normal (..., 3), hit, point, primary hit pairs)."""
    lead = o.shape[:-1]
    dt = o.dtype
    best_t = torch.full(lead, MISS_T, dtype=dt, device=o.device)
    colour = torch.zeros(lead + (4,), dtype=dt, device=o.device)
    normal = torch.zeros(lead + (3,), dtype=dt, device=o.device)
    pairs = torch.zeros(lead, dtype=torch.int64, device=o.device)
    if s["tri_verts"].shape[0]:
        v0, e1, e2 = _tri_edges(s)
        t, valid = _triangles(o, d, v0, e1, e2)
        pairs = pairs + valid.sum(-1)
        t = torch.where(valid, t, torch.full_like(t, MISS_T))
        t_tri, idx = torch.min(t, dim=-1)
        won = t_tri < best_t
        best_t = torch.where(won, t_tri, best_t)
        colour = torch.where(won[..., None], s["tri_colour"][idx], colour)
        n = _cross(e1, e2)
        n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                            min=1e-20)
        nh = n[idx]
        nh = torch.where(torch.sum(nh * d, dim=-1, keepdim=True) > 0, -nh, nh)
        normal = torch.where(won[..., None], nh, normal)
    if s["sphere_radius"].shape[0]:
        ts = _spheres(o, d, s["sphere_origin"], s["sphere_radius"])
        pairs = pairs + (ts != 0.0).sum(-1)
        ts = torch.where(ts == 0.0, torch.full_like(ts, MISS_T), ts)
        t_s, si = torch.min(ts, dim=-1)
        won = t_s < best_t
        best_t = torch.where(won, t_s, best_t)
        colour = torch.where(won[..., None], s["sphere_colour"][si], colour)
        p = o + t_s[..., None] * d
        ns = (p - s["sphere_origin"][si]) / torch.clamp(
            s["sphere_radius"][si][..., None], min=1e-20)
        normal = torch.where(won[..., None], ns, normal)
    hit = best_t < MISS_T
    return best_t, colour, normal, hit, o + best_t[..., None] * d, pairs


def occluded(o, d, s, t_max):
    """(bool (...,), occluder hit pairs (...,))."""
    occ = torch.zeros(o.shape[:-1], dtype=torch.bool, device=o.device)
    pairs = torch.zeros(o.shape[:-1], dtype=torch.int64, device=o.device)
    if s["tri_verts"].shape[0]:
        t, valid = _triangles(o, d, *_tri_edges(s))
        blocked = valid & (t > SHADOW_EPS) & (t < t_max[..., None])
        occ, pairs = occ | blocked.any(-1), pairs + blocked.sum(-1)
    if s["sphere_radius"].shape[0]:
        ts = _spheres(o, d, s["sphere_origin"], s["sphere_radius"])
        blocked = (ts != 0.0) & (ts > SHADOW_EPS) & (ts < t_max[..., None])
        occ, pairs = occ | blocked.any(-1), pairs + blocked.sum(-1)
    return occ, pairs


def shade(o, d, s, shading: str, shadows: bool):
    """(rgba (..., 4) float in 0..255, counts): counts holds per pixel the
    primary hit pairs, lit (bool), and per light whether it is occluded."""
    t, colour, normal, hit, point, pairs = nearest(o, d, s)
    n_l = s["lights.position"].shape[0]
    occ_any = torch.zeros_like(hit)
    if shading == "legacy":
        rgb = (255.0 - (t / LEGACY_FOG_MAX) * 255.0)[..., None] * colour[..., :3]
    else:
        to_l = s["lights.position"] - point[..., None, :]
        dist = torch.linalg.vector_norm(to_l, dim=-1)
        l_dir = to_l / torch.clamp(dist[..., None], min=1e-20)
        if shadows:
            origin = point + SHADOW_OFFSET * normal
            vis = []
            for li in range(n_l):
                occ, _ = occluded(origin, l_dir[..., li, :], s, dist[..., li])
                occ_any = occ_any | (occ & hit)
                vis.append((~occ).to(o.dtype))
            vis = torch.stack(vis, dim=-1)
        else:
            vis = torch.ones_like(dist)
        n = normal[..., None, :]
        ndotl = torch.clamp(torch.sum(n * l_dir, dim=-1), min=0.0)
        diffuse = torch.sum((s["lights.intensity"] * ndotl * vis)[..., None]
                            * s["lights.colour"], dim=-2)
        rgb = colour[..., :3] * (s["lights.ambient"] + diffuse)
        if shading == "phong":
            view = -d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                                    min=1e-20)
            r = 2.0 * torch.sum(n * l_dir, dim=-1, keepdim=True) * n - l_dir
            rdotv = torch.clamp(torch.sum(r * view[..., None, :], dim=-1), min=0.0)
            spec = s["lights.spec_strength"] * rdotv ** s["lights.shininess"]
            li_spec = s["lights.intensity"] * spec * vis * (ndotl > 0.0)
            rgb = rgb + torch.sum(li_spec[..., None] * s["lights.colour"], dim=-2)
        elif shading != "lambert":
            raise ValueError(f"unknown shading {shading!r}")
        rgb = torch.clamp(rgb, 0.0, 1.0) * 255.0
    rgb = torch.where(hit[..., None], rgb, torch.zeros_like(rgb))
    alpha = torch.full(rgb.shape[:-1] + (1,), 255.0, dtype=rgb.dtype,
                       device=rgb.device)
    counts = {"pairs": pairs, "lit": hit, "occluded": occ_any}
    return torch.cat([rgb, alpha], dim=-1), counts


def pack(rgba):
    """(..., 4) 0..255 -> (...) int32 words."""
    ch = torch.clamp(rgba.float(), 0, 255).to(torch.int32)
    return ch[..., 0] + ch[..., 1] * 256 + ch[..., 2] * 65536 + ALPHA_BITS


def unpack(words):
    """(...) int32 words -> (..., 3) int32 RGB."""
    w = words.to(torch.int64) & 0xFFFFFF
    return torch.stack([w & 255, (w >> 8) & 255, (w >> 16) & 255], dim=-1).to(torch.int32)


@torch.no_grad()
def render(s: dict, cam: dict, height: int, width: int, shading: str,
           shadows: bool, dtype=torch.float32, block_rows: int = 64,
           with_counts: bool = False):
    """The frame as float RGBA (H, W, 4) 0..255 (in `dtype`), and with
    `with_counts` the per-pixel counts of `shade`, row blocks concatenated.
    `s` holds the scene's arrays (float32; cast to `dtype` here)."""
    dev = s["sphere_origin"].device
    sd = {k: v.to(dtype) for k, v in s.items()}
    out, counts = [], []
    for r0 in range(0, height, block_rows):
        o, d = rays(cam, slice(r0, min(r0 + block_rows, height)), width, dev,
                    dtype)
        rgba, c = shade(o, d, sd, shading, shadows)
        out.append(rgba)
        counts.append(c)
    img = torch.cat(out)
    if not with_counts:
        return img
    return img, {k: torch.cat([c[k] for c in counts]) for k in counts[0]}
