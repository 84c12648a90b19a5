"""Brute soft differentiable render (forward AND backward) and the row
helpers the tiled soft path shares.

1. PREP (plain torch, differentiable): `_prep_soft_arrays` turns a packed
   scene into the kernels' operands; autograd of it and of `_camera_params`
   maps the kernels' gradients back onto the scene, the camera and the
   lights.
2. THE BRUTE KERNELS, behind one torch.autograd.Function
   (`SoftBruteFunction`): every pixel against every primitive, a streaming
   softmin over depth weighted by soft coverage, per-primitive (legacy,
   lambert) or aggregate (phong, lambert + soft shadows) shading, soft
   shadows over all primitives per light. On CUDA tensors `soft_brute_fwd`
   and `soft_brute_bwd` launch kernels/csrc/soft_brute.cu (the backward
   recomputes the forward per pixel); on CPU tensors both run
   `_soft_brute_plain`, the same function in vectorised torch, whose
   autograd is the backward's plain version. Any number of primitives.
3. ENTRY POINTS: `_soft_render_core` (the brute path, with gradients for
   every scene leaf, the camera, the lights and both temperatures) and
   `render_soft_pallas` (the tiled path of kernels/soft_tiled.py, which
   culls, and which takes the brute path for the frame where a tile's list
   overflows its K cap).
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.checkpoint import checkpoint

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
)
from opencl_ray_tracer_tpu_torch.ops.intersect import EPSILON
from opencl_ray_tracer_tpu_torch.ops.shading import LEGACY_FOG_MAX
from opencl_ray_tracer_tpu_torch.runtime.graph import device_scalar
from opencl_ray_tracer_tpu_torch.utils import tracing

NEG_BIG = -1e30
CK = 128         # the plain twin walks the padded primitives in these chunks
MAX_LIGHTS = 4   # the CUDA kernels keep per-light state in registers
# The CUDA kernels give each warp a patch of PATCH_W x PATCH_H pixels.
PATCH_W, PATCH_H = 8, 4

# Pixels per batch of the plain twin on the CPU (a (batch, CK) temporary is
# 2 MB) and on a card (16 MB). Under autograd each batch is checkpointed, so
# only one batch's graph, a few hundred temporaries, is alive at a time.
_PLAIN_PIXELS = {"cpu": 4096, "cuda": 32768}


def _safe_norm_rows(v):
    """Row norms with ZERO gradient at exactly-zero rows (padded prims): a
    plain sqrt has an infinite derivative at 0, and 0 * inf puts NaN into
    the padded lanes of the scene-parameter gradients."""
    s2 = torch.sum(v * v, dim=-1)
    pos = s2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, s2, torch.ones_like(s2))),
                       torch.zeros_like(s2))


def _safe_unit_rows(v):
    mag = _safe_norm_rows(v)[..., None]
    pos = mag > 0
    return torch.where(pos, v / torch.where(pos, mag, torch.ones_like(mag)),
                       torch.zeros_like(v))


def render_soft_pallas(scene, camera: Camera, config: RenderConfig) -> torch.Tensor:
    """Soft differentiable render through the tiled soft kernels, forward
    AND backward, at the config's K caps, or through the brute soft kernels
    where a tile's list overflows them (kernels/soft_tiled.py
    `render_soft_tiled`): CUDA on the card, their plain twins on the CPU.
    Legacy / lambert / phong, soft shadows when config.shadows, both camera
    families. Output float32 (H, W, 4), 0..255 domain. (The name is the JAX
    package's entry point this ports.)"""
    from opencl_ray_tracer_tpu_torch.kernels.soft_tiled import render_soft_tiled

    return render_soft_tiled(scene, camera, config)


# ---------------------------------------------------------------------------
# Operands of the brute soft kernels (differentiable)
# ---------------------------------------------------------------------------

def _prep_soft_arrays(packed):
    """tri geometry (14, Tp): v0, e1, e2, |e1|, |e2|, unit normal;
    tri albedo (Tp, 8); spheres (4, Sp) + albedo (Sp, 8)."""
    dev = packed.device
    e1t, e2t = packed.tri_e1.T, packed.tri_e2.T
    s1 = _safe_norm_rows(e1t)
    s2 = _safe_norm_rows(e2t)
    n = _safe_unit_rows(_cross(e1t, e2t))
    tri_geo = torch.cat(
        [packed.tri_v0, packed.tri_e1, packed.tri_e2, s1[None, :], s2[None, :],
         n.T], dim=0)
    tp, sp = packed.padded_tris, packed.padded_spheres
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
    tri_alb = torch.cat([packed.tri_colour.T[:, :3], zeros(tp, 5)], dim=1)
    sph_geo = torch.cat([packed.sph_origin, packed.sph_radius], dim=0)
    sph_alb = torch.cat([packed.sph_colour.T[:, :3], zeros(sp, 5)], dim=1)
    return tri_geo, tri_alb, sph_geo, sph_alb


def _static_cfg(packed, shading, shadows, normalize_dir):
    return dict(
        n_tris=packed.n_tris,
        n_spheres=packed.n_spheres,
        n_lights=packed.lights.position.shape[0],
        shading=shading,
        shadows=bool(shadows),
        normalize_dir=bool(normalize_dir),
    )


# ---------------------------------------------------------------------------
# The plain twin: one batch of pixels against every primitive, 128 at a
# time, in the order of operations of the JAX package's tile math
# (kernels/soft.py _tile_soft_math). Autograd of it is B7's plain version.
# ---------------------------------------------------------------------------

def _ray_bundle(pv, x, y, normalize_dir):
    o = tuple(pv[_P_O0 + q] + x * pv[_P_DOX + q] + y * pv[_P_DOY + q]
              for q in range(3))
    d = tuple(pv[_P_D0 + q] + x * pv[_P_DDX + q] + y * pv[_P_DDY + q]
              for q in range(3))
    if normalize_dir:
        inv = 1.0 / torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        d = tuple(c * inv for c in d)
    return o, d


def _rows(arr, c):
    s = slice(c * CK, (c + 1) * CK)
    return [arr[q, s][None, :] for q in range(arr.shape[0])]


def _tri_chunk_soft(tri_geo, c, o, d, tau_e):
    """Soft Möller–Trumbore over one chunk -> (t, cov, n) with n the
    unflipped unit-normal rows."""
    ox, oy, oz = o
    dx, dy, dz = d
    (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, s1, s2,
     nux, nuy, nuz) = _rows(tri_geo, c)
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
    tau_u = tau_e / tmax(s1, 1e-6)
    tau_v = tau_e / tmax(s2, 1e-6)
    tau_w = tau_e / tmax(0.5 * (s1 + s2), 1e-6)
    cov = (torch.sigmoid(u / tau_u) * torch.sigmoid(v / tau_v)
           * torch.sigmoid((1.0 - u - v) / tau_w))
    cov = torch.where(det_ok, cov, torch.zeros_like(cov))
    return t, cov, (nux, nuy, nuz)


def _sph_chunk_soft(sph_geo, c, o, d, tau_e):
    """Soft sphere test over one chunk -> (t, cov, n) with n the outward
    normal at the softplus-floored near intersection."""
    ox, oy, oz = o
    dx, dy, dz = d
    cx, cy, cz, r = _rows(sph_geo, c)
    lx, ly, lz = cx - ox, cy - oy, cz - oz
    tca = lx * dx + ly * dy + lz * dz
    d2 = lx * lx + ly * ly + lz * lz - tca * tca
    r2 = r * r
    margin = (r2 - d2) / tmax(2.0 * r, 1e-6)
    cov = torch.sigmoid(margin / tau_e) * torch.sigmoid(tca / tmax(tau_e, 1e-6))
    q_ = r2 - d2
    beta = tmax(tau_e, 1e-3) * tmax(2.0 * r, 1e-6)
    thc = torch.sqrt(beta * softplus(q_ / beta) + 1e-12)
    t = tca - thc
    # guarded reciprocal: 1/max(r, eps) has an infinite derivative at the
    # zero-radius padded slots, which would put NaN into their gradients
    rpos = r > 0
    rinv = torch.where(rpos, 1.0 / torch.where(rpos, r, torch.ones_like(r)),
                       torch.zeros_like(r))
    nx = (ox + t * dx - cx) * rinv
    ny = (oy + t * dy - cy) * rinv
    nz = (oz + t * dz - cz) * rinv
    return t, cov, (nx, ny, nz)


def _sum1(a):
    return torch.sum(a, dim=1, keepdim=True)


def _tile_soft_math(params, taus, tri_geo, tri_alb, sph_geo, sph_alb, x, y, *,
                    n_tris, n_spheres, n_lights, shading, shadows,
                    normalize_dir):
    """One batch of pixels (x, y: (B, 1) image coordinates) of the brute
    soft renderer -> (B, 4) [r, g, b, 255]. The running maximum m of the
    streaming softmin is held constant under autograd: the output does not
    depend on it."""
    pv = [params[i] for i in range(params.shape[0])]
    tau_d, tau_e = taus[0], taus[1]
    o, d = _ray_bundle(pv, x, y, normalize_dir)
    ambient = pv[_P_AMBIENT]
    n_tri_chunks = -(-tri_geo.shape[1] // CK) if n_tris else 0
    n_sph_chunks = -(-sph_geo.shape[1] // CK) if n_spheres else 0
    chunks = ([("tri", c) for c in range(n_tri_chunks)]
              + [("sph", c) for c in range(n_sph_chunks)])

    def isect(kind, c, oo, dd):
        if kind == "tri":
            return _tri_chunk_soft(tri_geo, c, oo, dd, tau_e)
        return _sph_chunk_soft(sph_geo, c, oo, dd, tau_e)

    def alb_chunk(kind, c):
        a = tri_alb if kind == "tri" else sph_alb
        return a[c * CK:(c + 1) * CK, 0:8]

    def light_scalars(li):
        base = _P_LIGHTS + li * _LIGHT_STRIDE
        return (pv[base:base + 3], pv[base + 3:base + 6], pv[base + 6])

    def ranking(t, cov):
        return torch.where(
            cov > 1e-12,
            -t * (1.0 / tau_d) + torch.log(tclip(cov, 1e-12, 1.0)),
            torch.full_like(t, NEG_BIG))

    def step_max(m, logit):
        with torch.no_grad():
            m_new = torch.maximum(m, logit.amax(dim=1, keepdim=True))
            scale = torch.exp(m - m_new)
        return m_new, scale, torch.exp(logit - m_new)

    def flipped(n):
        ndotd = n[0] * d[0] + n[1] * d[1] + n[2] * d[2]
        fl = torch.where(ndotd > 0, -1.0, 1.0)
        return (n[0] * fl, n[1] * fl, n[2] * fl)

    def log_unocc(c_):
        return _sum1(torch.log1p(-tclip(c_, 0.0, 1.0 - 1e-6)))

    aggregate = shading == "phong" or (shadows and shading == "lambert")
    zeros1 = torch.zeros_like(x)
    m = torch.full_like(x, NEG_BIG)

    if not aggregate:
        z, bacc = zeros1, zeros1
        s = [zeros1, zeros1, zeros1]
        for kind, c in chunks:
            t, cov, n = isect(kind, c, o, d)
            m, scale, e = step_max(m, ranking(t, cov))
            alb = alb_chunk(kind, c)
            z = z * scale + _sum1(e)
            if shading == "legacy":
                scalar_t = 255.0 - t * (255.0 / LEGACY_FOG_MAX)
                acc = (e * scalar_t) @ alb
                s = [s[q] * scale + acc[:, q:q + 1] for q in range(3)]
            else:  # lambert: alb * (ambient + sum_l lc * w_l), * 255
                p = tuple(o[q] + t * d[q] for q in range(3))
                if kind == "tri":
                    n = flipped(n)
                amb_s = (e @ alb) * ambient
                acc = [amb_s[:, q:q + 1] for q in range(3)]
                for li in range(n_lights):
                    lp, lc, lint = light_scalars(li)
                    tl = tuple(lp[q] - p[q] for q in range(3))
                    dist = torch.sqrt(tmax(tl[0] * tl[0] + tl[1] * tl[1]
                                           + tl[2] * tl[2], 1e-20))
                    ndotl = tmax((n[0] * tl[0] + n[1] * tl[1] + n[2] * tl[2])
                                 / dist, 0.0)
                    sl = (e * (lint * ndotl)) @ alb
                    acc = [acc[q] + lc[q] * sl[:, q:q + 1] for q in range(3)]
                s = [s[q] * scale + acc[q] * 255.0 for q in range(3)]
            bacc = bacc + log_unocc(cov)
        zinv = 1.0 / tmax(z, 1e-20)
        w_bg = torch.exp(bacc)
        rgb = [(1.0 - w_bg) * s[q] * zinv for q in range(3)]
        if shading != "legacy":
            rgb = [tclip(c_, 0.0, 255.0) for c_ in rgb]
    else:
        z, st, bacc = zeros1, zeros1, zeros1
        sn = [zeros1, zeros1, zeros1]
        s8 = torch.zeros((x.shape[0], 8), dtype=torch.float32, device=x.device)
        for kind, c in chunks:
            t, cov, n = isect(kind, c, o, d)
            if kind == "tri":
                n = flipped(n)
            m, scale, e = step_max(m, ranking(t, cov))
            z = z * scale + _sum1(e)
            st = st * scale + _sum1(e * t)
            sn = [sn[q] * scale + _sum1(e * n[q]) for q in range(3)]
            s8 = s8 * scale + e @ alb_chunk(kind, c)
            bacc = bacc + log_unocc(cov)
        zinv = 1.0 / tmax(z, 1e-20)
        w_bg = torch.exp(bacc)
        t_hat = st * zinv
        nrm = [sn[q] * zinv for q in range(3)]
        ninv = 1.0 / torch.sqrt(tmax(nrm[0] * nrm[0] + nrm[1] * nrm[1]
                                     + nrm[2] * nrm[2], 1e-20))
        nrm = [c_ * ninv for c_ in nrm]
        alb3 = [s8[:, q:q + 1] * zinv for q in range(3)]
        p = [o[q] + t_hat * d[q] for q in range(3)]
        vinv = 1.0 / torch.sqrt(tmax(d[0] * d[0] + d[1] * d[1] + d[2] * d[2],
                                     1e-20))
        v = [-d[q] * vinv for q in range(3)]
        diff = [zeros1, zeros1, zeros1]
        spec = [zeros1, zeros1, zeros1]
        for li in range(n_lights):
            lp, lc, lint = light_scalars(li)
            tl = [lp[q] - p[q] for q in range(3)]
            dist = torch.sqrt(tmax(tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2],
                                   1e-20))
            sd = tuple(tl[q] / dist for q in range(3))
            ndl = nrm[0] * sd[0] + nrm[1] * sd[1] + nrm[2] * sd[2]
            ndotl = tmax(ndl, 0.0)
            if shadows:
                so = tuple(p[q] + SHADOW_OFFSET * nrm[q] for q in range(3))
                tau_g = tmax(tau_e, 1e-4)
                shift = tmax(4.0 * tau_g, SHADOW_T_MIN)
                logvis = zeros1
                for kind, c in chunks:
                    t2, cov2, _ = isect(kind, c, so, sd)
                    occ = (cov2 * torch.sigmoid((t2 - shift) / tau_g)
                           * torch.sigmoid((dist - t2) / tau_g))
                    logvis = logvis + log_unocc(occ)
                vis = torch.exp(logvis)
            else:
                vis = 1.0
            wd = lint * ndotl * vis
            diff = [diff[q] + wd * lc[q] for q in range(3)]
            if shading == "phong":
                two_ndl = 2.0 * ndl
                r = [two_ndl * nrm[q] - sd[q] for q in range(3)]
                rdotv = tmax(r[0] * v[0] + r[1] * v[1] + r[2] * v[2], 0.0)
                ws = (pv[_P_SPEC]
                      * torch.exp(pv[_P_SHINE] * torch.log(tmax(rdotv, 1e-20)))
                      * lint * vis * (ndotl > 0.0))
                spec = [spec[q] + ws * lc[q] for q in range(3)]
        rgb = [tclip((1.0 - w_bg) * (alb3[q] * (ambient + diff[q]) + spec[q])
                     * 255.0, 0.0, 255.0) for q in range(3)]
    return torch.cat(rgb + [torch.full_like(x, 255.0)], dim=1)


def _soft_brute_plain(params, taus, tri_geo, tri_alb, sph_geo, sph_alb, *,
                      height, width, cfg):
    """The brute soft forward as vectorised torch; differentiable in all six
    tensor inputs. Pixels are processed in batches of `_PLAIN_PIXELS`, each
    checkpointed under autograd. Returns (H, W, 4) float32."""
    inputs = (params, taus, tri_geo, tri_alb, sph_geo, sph_alb)
    dev = params.device
    n_pix = height * width
    need_grad = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    batch_pixels = _PLAIN_PIXELS.get(dev.type, _PLAIN_PIXELS["cpu"])
    outs = []
    for p0 in range(0, n_pix, batch_pixels):
        flat = torch.arange(p0, min(p0 + batch_pixels, n_pix), device=dev)
        yi = flat // width
        x = (flat - yi * width).to(torch.float32)[:, None]
        y = yi.to(torch.float32)[:, None]

        def batch(*ts, x=x, y=y):
            return _tile_soft_math(*ts, x, y, **cfg)

        outs.append(checkpoint(batch, *inputs, use_reentrant=False)
                    if need_grad else batch(*inputs))
    return torch.cat(outs, dim=0).reshape(height, width, 4)


# ---------------------------------------------------------------------------
# Kernel wrappers + the autograd Function
# ---------------------------------------------------------------------------

def _check_brute(params, taus, tri_geo, tri_alb, sph_geo, sph_alb, height,
                 width, cfg):
    dev = params.device
    n_lights = cfg["n_lights"]
    if not 1 <= n_lights <= MAX_LIGHTS:
        raise ValueError(f"the soft kernels take 1-{MAX_LIGHTS} lights, got {n_lights}")
    tp, sp = tri_geo.shape[-1], sph_geo.shape[-1]
    if not (0 <= cfg["n_tris"] <= tp and 0 <= cfg["n_spheres"] <= sp
            and height > 0 and width > 0):
        raise ValueError("primitive counts or frame size out of range")
    for name, t, shape in (
        ("params", params, (_P_LIGHTS + n_lights * _LIGHT_STRIDE,)),
        ("taus", taus, (2,)), ("tri_geo", tri_geo, (14, tp)),
        ("tri_alb", tri_alb, (tp, 8)), ("sph_geo", sph_geo, (4, sp)),
        ("sph_alb", sph_alb, (sp, 8)),
    ):
        _check(name, t, torch.float32, shape, dev)


def _live_patches(g, patch_h=PATCH_H, patch_w=PATCH_W):
    """The patches of a cotangent g (H, W, 4) that hold a non-zero value in
    a colour channel (alpha is a constant: its cotangent reaches nothing),
    as sorted flat patch indices, row-major over ceil(H / patch_h) x
    ceil(W / patch_w) patches. The CUDA backward builds this list on the
    card (in no order) and walks nothing else; this is its plain version,
    which `_soft_brute_bwd_cuda`'s callers hold the card's list against."""
    h, w = g.shape[:2]
    npy, npx = -(-h // patch_h), -(-w // patch_w)
    nz = torch.zeros((npy * patch_h, npx * patch_w), dtype=torch.bool,
                     device=g.device)
    nz[:h, :w] = (g[..., :3] != 0).any(-1)
    live = nz.reshape(npy, patch_h, npx, patch_w).any(3).any(1)
    return torch.nonzero(live.reshape(-1))[:, 0]


def _brute_ints(tri_geo, sph_geo, height, width, cfg):
    return [height, width, tri_geo.shape[1], sph_geo.shape[1], cfg["n_tris"],
            cfg["n_spheres"], cfg["n_lights"], _SHADING_CODES[cfg["shading"]],
            int(cfg["shadows"]), int(cfg["normalize_dir"])]


def _row_scratch(cfg, dev, make):
    """The kernels' derived rows (or their gradients): 16 + 8 floats per
    real primitive."""
    n = max(cfg["n_tris"] + cfg["n_spheres"], 1)
    return make((n, 24), dtype=torch.float32, device=dev)


def _raise_on(rc, what):
    if rc != 0:
        from opencl_ray_tracer_tpu_torch.kernels._build import load_library

        msg = load_library().octrt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {rc})")


def soft_brute_fwd(params, taus, tri_geo, tri_alb, sph_geo, sph_alb, *,
                   height, width, cfg, run_if=None, want: int = 0) -> torch.Tensor:
    """B6, the brute soft forward -> (H, W, 4) float32. CUDA tensors launch
    kernels/csrc/soft_brute.cu (built on first use) or raise; CPU tensors
    run `_soft_brute_plain` without autograd. `run_if` (one int32 on the
    device, or None) is the device-side branch of `lax.cond`: the kernels do
    their work only where *run_if == want, else the frame is zeros (the
    twin: a torch.where)."""
    inputs = (params, taus, tri_geo, tri_alb, sph_geo, sph_alb)
    dev = params.device
    _check_run_if(run_if, dev)
    if dev.type == "cpu":
        with torch.no_grad():
            return _select_branch(
                _soft_brute_plain(*inputs, height=height, width=width, cfg=cfg),
                run_if, want)
    if dev.type != "cuda":
        raise ValueError(f"soft_brute_fwd runs on cuda or cpu tensors, got {dev}")
    _check_brute(*inputs, height, width, cfg)
    from opencl_ray_tracer_tpu_torch.kernels._build import load_library

    lib = load_library()
    out = _out_buffer((height, width, 4), torch.float32, dev, run_if)
    scratch = _row_scratch(cfg, dev, torch.empty)
    p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.octrt_soft_brute_fwd(
            *(p(t) for t in inputs), p(out), p(scratch),
            *_brute_ints(tri_geo, sph_geo, height, width, cfg), p(run_if),
            int(want), ctypes.c_void_p(stream))
    _raise_on(rc, "soft_brute forward")
    tracing.count("launch.B6")
    return out


def soft_brute_bwd(params, taus, tri_geo, tri_alb, sph_geo, sph_alb, g, *,
                   height, width, cfg):
    """B7, the brute soft backward: pixel cotangents g (H, W, 4) -> gradients
    of (params, taus, tri_geo, tri_alb, sph_geo, sph_alb). CUDA tensors
    launch the CUDA backward (it works only on the patches of g that hold a
    non-zero value, recomputes the forward per pixel there and sums over
    pixels with atomics, so sums vary in their last bits from run to run);
    CPU tensors take autograd of `_soft_brute_plain`."""
    inputs = (params, taus, tri_geo, tri_alb, sph_geo, sph_alb)
    dev = params.device
    if dev.type == "cpu":
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in inputs]
            out = _soft_brute_plain(*leaves, height=height, width=width, cfg=cfg)
            grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
        return tuple(torch.zeros_like(t) if gr is None else gr
                     for t, gr in zip(inputs, grads))
    if dev.type != "cuda":
        raise ValueError(f"soft_brute_bwd runs on cuda or cpu tensors, got {dev}")
    return _soft_brute_bwd_cuda(inputs, g, height, width, cfg)[0]


def _soft_brute_bwd_cuda(inputs, g, height, width, cfg):
    """Launch B7 on CUDA tensors -> (the six gradients, live). `live` is the
    kernel's int32 work list as it leaves it: live[0] the number of patches
    of g that hold a non-zero cotangent, live[2 : 2 + live[0]] those patches
    in no order (`_live_patches` is its plain version)."""
    params, _, tri_geo, _, sph_geo, _ = inputs
    dev = params.device
    _check_brute(*inputs, height, width, cfg)
    g = g.to(torch.float32).contiguous()
    _check("g", g, torch.float32, (height, width, 4), dev)
    from opencl_ray_tracer_tpu_torch.kernels._build import load_library

    lib = load_library()
    # one zeroed buffer for the row-gradient scratch and the six gradients
    # (views of it): one allocation and one fill, not seven
    scratch = _row_scratch(cfg, dev, torch.empty)
    sizes = [scratch.numel()] + [t.numel() for t in inputs]
    d_scratch, *grads = torch.zeros(sum(sizes), dtype=torch.float32,
                                    device=dev).split(sizes)
    grads = [gr.view_as(t) for gr, t in zip(grads, inputs)]
    live = torch.empty(2 + -(-width // PATCH_W) * -(-height // PATCH_H),
                       dtype=torch.int32, device=dev)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.octrt_soft_brute_bwd(
            *(p(t) for t in inputs), p(g), *(p(t) for t in grads),
            p(scratch), p(d_scratch), p(live),
            *_brute_ints(tri_geo, sph_geo, height, width, cfg),
            ctypes.c_void_p(stream))
    _raise_on(rc, "soft_brute backward")
    tracing.count("launch.B7")
    return tuple(grads), live


class SoftBruteFunction(torch.autograd.Function):
    """(params, taus, tri_geo, tri_alb, sph_geo, sph_alb) + the frame size
    and static cfg -> (H, W, 4) float image. Forward is B6 and backward B7
    on CUDA tensors; the plain twin and its autograd on CPU tensors. The
    backward always recomputes: nothing but the inputs is saved. With
    `run_if` the forward is a branch of `lax.cond` (see `soft_brute_fwd`);
    the backward needs no flag: the branch not taken gets a zero cotangent,
    on which B7 returns exact zeros."""

    @staticmethod
    def forward(ctx, params, taus, tri_geo, tri_alb, sph_geo, sph_alb, height,
                width, cfg, run_if=None, want=0):
        ctx.save_for_backward(params, taus, tri_geo, tri_alb, sph_geo, sph_alb)
        ctx.frame = (height, width, cfg)
        return soft_brute_fwd(params, taus, tri_geo, tri_alb, sph_geo, sph_alb,
                              height=height, width=width, cfg=cfg,
                              run_if=run_if, want=want)

    @staticmethod
    def backward(ctx, g):
        height, width, cfg = ctx.frame
        grads = soft_brute_bwd(*ctx.saved_tensors, g, height=height,
                               width=width, cfg=cfg)
        return tuple(grads) + (None, None, None, None, None)


def _soft_render_core(packed, camera: Camera, tau_d, tau_e, height: int,
                      width: int, shading: str, shadows: bool,
                      normalize_dir: bool, run_if=None,
                      want: int = 0) -> torch.Tensor:
    """The brute soft frame -> (H, W, 4) float32, 0..255 domain, with
    autograd to every leaf of the packed scene, the camera's tensors, the
    lights and both temperatures (tensors or floats). With `run_if` the
    forward is the brute branch of `lax.cond` (zeros unless *run_if ==
    want; see `soft_brute_fwd`)."""
    dev = packed.device
    arrays = [a.contiguous() for a in _prep_soft_arrays(packed)]
    params = _camera_params(camera, packed.lights).contiguous()
    taus = torch.stack([device_scalar(t, dev) for t in (tau_d, tau_e)])
    cfg = _static_cfg(packed, shading, shadows, normalize_dir)
    return SoftBruteFunction.apply(params, taus, *arrays, height, width, cfg,
                                   run_if, want)
