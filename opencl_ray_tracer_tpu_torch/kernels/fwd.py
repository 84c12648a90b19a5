"""Brute-force hard forward frame + the per-frame preparation shared by the
forward kernels.

1. PREP (plain torch, differentiable): the parameter-vector layout and the
   per-primitive operand arrays and affine coefficients that both the brute
   kernel here and the tiled kernel (kernels/fwd_tiled.py) consume.
2. THE BRUTE KERNEL: every pixel against every primitive, no binning.
   `brute_kernel` launches kernels/csrc/fwd_brute.cu on CUDA tensors and runs
   `_brute_kernel_plain`, the same function in vectorised torch, on CPU
   tensors. Shared-direction cameras take the affine primary tests
   (`_prep_affine_coefs`), pinhole cameras the general Möller–Trumbore and
   geometric sphere tests; shadow rays always take the general tests.
3. ENTRY POINTS: `render_pallas` / `render_pallas_packed` (the names of the
   JAX package's entry points this ports) -> (H, W, 4) int32 or float32, and
   `_render_pallas_jit`, the same frame with no host read, which a CUDA
   graph can capture (runtime/graph.py) and which takes the kernel's
   device-side branch (`run_if`, see `brute_kernel`).

Exact-semantics notes: miss-as-0.0 sphere sentinel, tca < 0 miss, negative-t
wins, strict-< ordering (triangles before spheres), closest init 300000.0,
the first index wins a tie.
"""

from __future__ import annotations

import ctypes

import torch

from opencl_ray_tracer_tpu_torch.camera import Camera
from opencl_ray_tracer_tpu_torch.config import RenderConfig
from opencl_ray_tracer_tpu_torch.ops.intersect import EPSILON, MISS_T
from opencl_ray_tracer_tpu_torch.ops.shading import LEGACY_FOG_MAX
from opencl_ray_tracer_tpu_torch.utils import tracing

PRIM_CHUNK = 128  # the plain twin walks the padded primitives in these chunks

# Elements per (pixel batch x chunk) temporary of the plain twin.
_PLAIN_MAX_ELEMS = 1 << 23

_SHADING_CODES = {"legacy": 0, "lambert": 1, "phong": 2}

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


# ---------------------------------------------------------------------------
# The brute kernel: plain twin + CUDA wrapper
# ---------------------------------------------------------------------------

def _tri_chunk_t(g, o, d):
    """Möller–Trumbore over one chunk; g: 9 rows (1, CK), o/d: 3 x (B, 1)."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = g
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
    valid = det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, valid


def _sph_chunk_t(g, o, d):
    """Geometric sphere test over one chunk (tca < 0 misses, an exact-0
    distance is discarded); g: 4 rows (1, CK)."""
    ox, oy, oz = o
    dx, dy, dz = d
    cx, cy, cz, r = g
    lx, ly, lz = cx - ox, cy - oy, cz - oz
    tca = lx * dx + ly * dy + lz * dz
    m2 = lx * lx + ly * ly + lz * lz - tca * tca
    r2 = r * r
    hit = (tca >= 0.0) & (m2 <= r2)
    t0 = tca - torch.sqrt(torch.clamp(r2 - m2, min=0.0))
    return t0, hit & (t0 != 0.0)


def _tri_chunk_t_affine(c, x, y):
    u = c[0] + x * c[1] + y * c[2]
    v = c[3] + x * c[4] + y * c[5]
    t = c[6] + x * c[7] + y * c[8]
    return t, (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)


def _sph_chunk_t_affine(c, x, y, x2, y2, xy):
    tca = c[0] + x * c[1] + y * c[2]
    d2 = c[3] + x * c[4] + y * c[5] + x2 * c[6] + y2 * c[7] + xy * c[8]
    hit = (tca >= 0.0) & (d2 <= c[9])
    t0 = tca - torch.sqrt(torch.clamp(c[9] - d2, min=0.0))
    return t0, hit & (t0 != 0.0)


def _chunk_rows(arr, c):
    """Rows of a (R, Np) operand over chunk c, each (1, CK)."""
    s = slice(c * PRIM_CHUNK, (c + 1) * PRIM_CHUNK)
    return [arr[q, s][None, :] for q in range(arr.shape[0])]


def _brute_kernel_plain(params, tri_geo, tri_attr, sph_geo, sph_attr,
                        tri_coef, sph_coef, *, height, width, n_tris,
                        n_spheres, shading, shadows, normalize_dir):
    """The brute kernel as vectorised torch over (pixel batch, chunk of 128
    primitives): same inputs and output as `brute_kernel`, the same
    arithmetic in the same order. It walks the padded primitive arrays
    (padded triangles are degenerate, padded spheres lie beyond MISS_T), in
    pixel batches that bound a temporary to `_PLAIN_MAX_ELEMS` elements.
    Returns (height, width, 4) float32 [r, g, b, 255]."""
    dev = params.device
    affine = not normalize_dir
    n_tri_chunks = tri_geo.shape[1] // PRIM_CHUNK if n_tris else 0
    n_sph_chunks = sph_geo.shape[1] // PRIM_CHUNK if n_spheres else 0
    n_lights = (params.shape[0] - _P_LIGHTS) // _LIGHT_STRIDE
    prm = [params[i] for i in range(params.shape[0])]
    n_pix = height * width
    out = torch.empty((n_pix, 4), dtype=torch.float32, device=dev)
    batch = max(1, _PLAIN_MAX_ELEMS // PRIM_CHUNK)

    def occluded_along(o, d, t_max):
        occ = torch.zeros_like(t_max, dtype=torch.bool)
        for c in range(n_tri_chunks):
            t, valid = _tri_chunk_t(_chunk_rows(tri_geo, c), o, d)
            blocked = valid & (t > 1e-3) & (t < t_max)
            occ = occ | blocked.any(dim=1, keepdim=True)
        for c in range(n_sph_chunks):
            t, valid = _sph_chunk_t(_chunk_rows(sph_geo, c), o, d)
            blocked = valid & (t > 1e-3) & (t < t_max)
            occ = occ | blocked.any(dim=1, keepdim=True)
        return occ

    for p0 in range(0, n_pix, batch):
        flat = torch.arange(p0, min(p0 + batch, n_pix), device=dev)
        yi = flat // width
        x = (flat - yi * width).to(torch.float32)[:, None]
        y = yi.to(torch.float32)[:, None]
        o = tuple(prm[_P_O0 + q] + x * prm[_P_DOX + q] + y * prm[_P_DOY + q]
                  for q in range(3))
        d = tuple(prm[_P_D0 + q] + x * prm[_P_DDX + q] + y * prm[_P_DDY + q]
                  for q in range(3))
        if normalize_dir:
            inv = 1.0 / torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
            d = tuple(c_ * inv for c_ in d)
        x2, y2, xy = x * x, y * y, x * y

        best_t = torch.full_like(x, MISS_T)
        best_idx = torch.zeros_like(x, dtype=torch.int64)
        best_sph = torch.zeros_like(x, dtype=torch.bool)
        for is_sph, n_chunks in ((False, n_tri_chunks), (True, n_sph_chunks)):
            for c in range(n_chunks):
                if affine and is_sph:
                    t, valid = _sph_chunk_t_affine(_chunk_rows(sph_coef, c),
                                                   x, y, x2, y2, xy)
                elif affine:
                    t, valid = _tri_chunk_t_affine(_chunk_rows(tri_coef, c), x, y)
                elif is_sph:
                    t, valid = _sph_chunk_t(_chunk_rows(sph_geo, c), o, d)
                else:
                    t, valid = _tri_chunk_t(_chunk_rows(tri_geo, c), o, d)
                tpair = torch.where(valid, t, MISS_T)
                cmin, first = tpair.min(dim=1, keepdim=True)
                wins = cmin < best_t
                best_t = torch.where(wins, cmin, best_t)
                best_idx = torch.where(wins, first + c * PRIM_CHUNK, best_idx)
                best_sph = torch.where(wins, is_sph, best_sph)

        hit = best_t < MISS_T
        idx = best_idx[:, 0]
        attr = torch.where(best_sph,
                           sph_attr[idx.clamp(max=sph_attr.shape[0] - 1)],
                           tri_attr[idx.clamp(max=tri_attr.shape[0] - 1)])
        attr = torch.where(hit, attr, 0.0)
        col = [attr[:, q:q + 1] for q in range(8)]
        cr, cg, cb = col[0], col[1], col[2]

        if shading == "legacy":
            scalar = 255.0 - best_t * (255.0 / LEGACY_FOG_MAX)
            rgb = [torch.where(hit, c_ * scalar, 0.0) for c_ in (cr, cg, cb)]
        else:
            px = o[0] + best_t * d[0]
            py = o[1] + best_t * d[1]
            pz = o[2] + best_t * d[2]
            ax, ay, az, irad, is_sph = col[3], col[4], col[5], col[6], col[7]
            nsx = (px - ax) * irad
            nsy = (py - ay) * irad
            nsz = (pz - az) * irad
            flip = torch.where(ax * d[0] + ay * d[1] + az * d[2] > 0, -1.0, 1.0)
            sph_w = is_sph > 0.5
            nx = torch.where(sph_w, nsx, ax * flip)
            ny = torch.where(sph_w, nsy, ay * flip)
            nz = torch.where(sph_w, nsz, az * flip)
            ninv = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                                min=1e-20))
            nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
            vinv = 1.0 / torch.sqrt(torch.clamp(
                d[0] * d[0] + d[1] * d[1] + d[2] * d[2], min=1e-20))
            vx, vy, vz = -d[0] * vinv, -d[1] * vinv, -d[2] * vinv

            ambient, spec_k, shine = prm[_P_AMBIENT], prm[_P_SPEC], prm[_P_SHINE]
            zero = torch.zeros_like(best_t)
            diff = [zero, zero, zero]
            spec = [zero, zero, zero]
            for li in range(n_lights):
                base = _P_LIGHTS + li * _LIGHT_STRIDE
                lc = prm[base + 3:base + 6]
                lint = prm[base + 6]
                tlx, tly, tlz = prm[base] - px, prm[base + 1] - py, prm[base + 2] - pz
                dist = torch.sqrt(torch.clamp(tlx * tlx + tly * tly + tlz * tlz,
                                              min=1e-20))
                ldx, ldy, ldz = tlx / dist, tly / dist, tlz / dist
                ndl = nx * ldx + ny * ldy + nz * ldz
                ndotl = torch.clamp(ndl, min=0.0)
                if shadows:
                    so = (px + 1e-2 * nx, py + 1e-2 * ny, pz + 1e-2 * nz)
                    occ = occluded_along(so, (ldx, ldy, ldz), dist)
                    vis = torch.where(occ, 0.0, 1.0)
                else:
                    vis = 1.0
                wdiff = lint * ndotl * vis
                diff = [diff[q] + wdiff * lc[q] for q in range(3)]
                if shading == "phong":
                    two_ndl = 2.0 * ndl
                    rx = two_ndl * nx - ldx
                    ry = two_ndl * ny - ldy
                    rz = two_ndl * nz - ldz
                    rdotv = torch.clamp(rx * vx + ry * vy + rz * vz, min=0.0)
                    wspec = (spec_k
                             * torch.exp(shine * torch.log(torch.clamp(rdotv, min=1e-20)))
                             * lint * vis * (ndotl > 0.0))
                    spec = [spec[q] + wspec * lc[q] for q in range(3)]
            rgb = [torch.where(hit, torch.clamp(c_ * (ambient + diff[q]) + spec[q],
                                                0.0, 1.0) * 255.0, 0.0)
                   for q, c_ in enumerate((cr, cg, cb))]
        out[flat] = torch.cat(rgb + [torch.full_like(best_t, 255.0)], dim=1)
    return out.reshape(height, width, 4)


def _check_run_if(run_if, device):
    """The device-side branch flag a kernel wrapper takes: None, or one int32
    on the kernel's device."""
    if run_if is None:
        return
    if run_if.dtype != torch.int32 or run_if.numel() != 1 or run_if.device != device:
        raise ValueError(f"run_if: one int32 on {device}, got {run_if.dtype} "
                         f"{tuple(run_if.shape)} on {run_if.device}")


def _select_branch(out, run_if, want):
    """The plain twins' form of a kernel's device-side branch: `out` where
    run_if is None or equals want, else zeros (what a skipped CUDA launch
    leaves in its buffer)."""
    if run_if is None:
        return out
    return torch.where(run_if.reshape(()) == want, out, torch.zeros_like(out))


def _out_buffer(shape, dtype, device, run_if):
    """A kernel's output buffer: zeros where the launch may be skipped (a
    branch not taken leaves defined values for a torch.where or a backward to
    read), else uninitialised."""
    make = torch.empty if run_if is None else torch.zeros
    return make(shape, dtype=dtype, device=device)


def _check(name, t, dtype, shape=None, device=None):
    """What every kernel wrapper asks of a tensor before it passes its
    pointer on."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def brute_kernel(params, tri_geo, tri_attr, sph_geo, sph_attr, tri_coef,
                 sph_coef, *, height: int, width: int, n_tris: int,
                 n_spheres: int, shading: str, shadows: bool,
                 normalize_dir: bool, run_if=None, want: int = 0):
    """The brute hard forward kernel -> (height, width, 4) float32.

    CUDA tensors launch kernels/csrc/fwd_brute.cu (built on first use) or
    raise; CPU tensors run `_brute_kernel_plain`. `run_if` (one int32 on
    the device, or None) is the device-side branch of `lax.cond`: the
    kernel does its work only where *run_if == want, else its frame is
    zeros (the twin: a torch.where). Inputs: params (21+7L,);
    tri_geo (9, Tp), tri_attr (Tp, 8), sph_geo (4, Sp), sph_attr (Sp, 8);
    for shared-direction cameras (normalize_dir False) also tri_coef
    (9, Tp) and sph_coef (10, Sp), else None. n_tris / n_spheres are the
    real primitive counts: the CUDA kernel stops there (no padded primitive
    can win a hit or block a shadow ray), the twin walks the padding."""
    args = (params, tri_geo, tri_attr, sph_geo, sph_attr, tri_coef, sph_coef)
    kw = dict(height=height, width=width, n_tris=n_tris, n_spheres=n_spheres,
              shading=shading, shadows=shadows, normalize_dir=normalize_dir)
    if shading not in _SHADING_CODES:
        raise ValueError(f"bad shading {shading!r}")
    dev = params.device
    _check_run_if(run_if, dev)
    if dev.type == "cpu":
        return _select_branch(_brute_kernel_plain(*args, **kw), run_if, want)
    if dev.type != "cuda":
        raise ValueError(f"brute_kernel runs on cuda or cpu tensors, got {dev}")

    n_lights = (params.shape[0] - _P_LIGHTS) // _LIGHT_STRIDE
    if n_lights < 1 or params.shape[0] != _P_LIGHTS + n_lights * _LIGHT_STRIDE:
        raise ValueError(f"params length {params.shape[0]} is not 21 + 7L")
    tp, sp = tri_geo.shape[1], sph_geo.shape[1]
    if not (0 <= n_tris <= tp and 0 <= n_spheres <= sp and height > 0 and width > 0):
        raise ValueError("primitive counts or frame size out of range")
    _check("params", params, torch.float32, params.shape, dev)
    _check("tri_geo", tri_geo, torch.float32, (9, tp), dev)
    _check("tri_attr", tri_attr, torch.float32, (tp, 8), dev)
    _check("sph_geo", sph_geo, torch.float32, (4, sp), dev)
    _check("sph_attr", sph_attr, torch.float32, (sp, 8), dev)
    affine = not normalize_dir
    if affine:
        _check("tri_coef", tri_coef, torch.float32, (9, tp), dev)
        _check("sph_coef", sph_coef, torch.float32, (10, sp), dev)

    from opencl_ray_tracer_tpu_torch.kernels._build import load_library

    lib = load_library()
    out = _out_buffer((height, width, 4), torch.float32, dev, run_if)
    p = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else None)  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.octrt_fwd_brute(
            p(params), p(tri_geo), p(tri_attr), p(sph_geo), p(sph_attr),
            p(tri_coef if affine else None), p(sph_coef if affine else None),
            p(out), height, width, tp, sp, n_tris, n_spheres, n_lights,
            _SHADING_CODES[shading], int(bool(shadows)), int(affine),
            p(run_if), int(want), ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(
            f"fwd_brute kernel launch failed: {lib.octrt_cuda_error_string(rc).decode()}"
            f" (cudaError {rc})"
        )
    tracing.count("launch.B3")
    return out


# ---------------------------------------------------------------------------
# Frame entry points
# ---------------------------------------------------------------------------

def brute_kernel_inputs(packed, camera: Camera, config: RenderConfig):
    """The (args, kwargs) that `brute_kernel` (and its twin) take for a
    frame."""
    return _brute_inputs(packed, camera, height=config.height,
                         width=config.width, shading=config.shading,
                         shadows=config.shadows)


def _brute_inputs(packed, camera: Camera, *, height, width, shading, shadows):
    tri_geo, tri_attr, sph_geo, sph_attr = _prep_scene_arrays(packed)
    tri_coef = sph_coef = None
    if not camera.normalize:  # shared-direction cameras: the affine tests
        tri_coef, sph_coef = _prep_affine_coefs(packed, camera)
        tri_coef, sph_coef = tri_coef.contiguous(), sph_coef.contiguous()
    args = (_camera_params(camera, packed.lights).contiguous(),
            tri_geo.contiguous(), tri_attr.contiguous(), sph_geo.contiguous(),
            sph_attr.contiguous(), tri_coef, sph_coef)
    kw = dict(height=height, width=width, n_tris=packed.n_tris,
              n_spheres=packed.n_spheres, shading=shading, shadows=shadows,
              normalize_dir=camera.normalize)
    return args, kw


@torch.no_grad()
def _render_pallas_jit(packed, camera: Camera, *, height: int, width: int,
                       shading: str, shadows: bool, as_int: bool = False,
                       run_if=None, want: int = 1) -> torch.Tensor:
    """The brute frame with no host read (the JAX package's
    `_render_pallas_jit`, fwd.py:513-519): (H, W, 4) float32, or int32
    truncated for `as_int`. With `run_if` the kernel runs only where
    *run_if == want and the frame is zeros elsewhere: the fallback branch
    of `fwd_tiled._render_tiled_jit`."""
    args, kw = _brute_inputs(packed, camera, height=height, width=width,
                             shading=shading, shadows=shadows)
    rgba = brute_kernel(*args, **kw, run_if=run_if, want=want)
    return torch.trunc(rgba).to(torch.int32) if as_int else rgba


def render_pallas(scene, camera: Camera, config: RenderConfig) -> torch.Tensor:
    """Render with the brute kernel (every pixel against every primitive).
    Returns (H, W, 4)."""
    return render_pallas_packed(scene.pack(), camera, config)


@torch.no_grad()
def render_pallas_packed(packed, camera: Camera, config: RenderConfig) -> torch.Tensor:
    """Brute render from an already-packed scene: (H, W, 4) int32 (truncated)
    for framebuffer_dtype "int", else float32. The brute kernel has no
    packed-word output."""
    if config.framebuffer_dtype == "packed":
        raise ValueError("the brute kernel has no packed-word framebuffer; "
                         "use framebuffer_dtype 'int' or 'float'")
    return _render_pallas_jit(packed, camera, height=config.height,
                              width=config.width, shading=config.shading,
                              shadows=config.shadows,
                              as_int=config.framebuffer_dtype == "int")
