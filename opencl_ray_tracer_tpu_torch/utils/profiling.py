"""Profiling and speed of light on one NVIDIA H100 — the counterpart of the
JAX package's utils/profiling.py (whose v5e VPU estimates do not carry
over): the device's busy time per call, and the least time the card could
take for each kernel's work (spans and counters: `utils.tracing`).

A bound is the larger of two times: the operations that this run's data
needs over the card's peak float32 rate, and the bytes that the function
must move (each input read once, each output written once) over its memory
rate. The bound functions run wherever their tensors lie: on the CPU they
call the kernels' plain twins.
"""

from __future__ import annotations

import re
import time
from typing import Optional

import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside the
# tensor cores, and device memory.
PEAK_FP32 = 67e12
PEAK_HBM = 3.35e12

# Operations per unit of work, counted from the expressions of the kernels'
# sources: every add, multiply, compare, select, min/max counts 1, and so
# does every divide, sqrt, exp, log and log1p (a floor: those take several
# instruction slots). Reductions across threads are not counted: the
# function does not need them.
OPS = {
    # hard tests (fwd_tiled.cu, fwd_brute.cu), the nearest-hit update included
    "tri_affine": 19, "sph_affine": 22, "tri_general": 53, "sph_general": 23,
    "sh_tri_planes": 76, "sh_sph": 24,
    # hard shading: hit point, normal, view vector; then per light
    "shade_fixed": 40, "shade_light": 45,
    # soft candidates (soft_tiled.cuh): test, three or two sigmoids, rank,
    # the online max and the aggregate sums
    "soft_tri_affine": 77, "soft_sph_affine": 100,
    "soft_tri_general": 120, "soft_sph_general": 101,
    "occ_tri": 87, "occ_sph": 64,
    # soft per-pixel finish: aggregate geometry, then shading per light
    "soft_finish": 60, "soft_light": 70,
}
# The reverse of each soft unit above, counted the same way from the
# hand-written reverses of soft_tiled.cuh (tri_bwd / sph_bwd / tri_sh_bwd /
# sph_sh_bwd with bary_bwd, sph_cov_t_bwd and cross_bwd, cand_bwd, occ_bwd,
# shade_agg_bwd + geom_bwd + ctx_bwd): only the expressions that produce a
# cotangent. What a reverse recomputes of its forward (the sigmoids, u, v,
# the ray geometry) is not counted again: a backward needs one forward, the
# unit above, plus this.
OPS_BWD = {
    "soft_tri_affine": 120, "soft_sph_affine": 169,
    "soft_tri_general": 225, "soft_sph_general": 176,
    "occ_tri": 189, "occ_sph": 119,
    "soft_finish": 239, "soft_light": 171,
}


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of operations over the peak float32
    rate and bytes over the peak memory rate."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_HBM * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def per_tile(mask, nty, ntx):
    """Per-tile sums of a (H, W) pixel mask, (nty * ntx,) int64."""
    h, w = mask.shape
    full = torch.zeros((nty * 64, ntx * 128), dtype=torch.int64, device=mask.device)
    full[:h, :w] = mask
    return full.reshape(nty, 64, ntx, 128).sum((1, 3)).reshape(-1)


def soft_covered(packed, cam, tau_e, h, w):
    """(H, W) bool: the pixels whose soft coverage 1 - w_bg is not exactly
    zero in float32, w_bg = prod(1 - cov) over every primitive. Every other
    pixel of a soft frame is 0 whatever its shading and shadows are, so only
    these need the finish, the per-light shading and the occluder walks."""
    from opencl_ray_tracer_tpu_torch.kernels import soft as B

    with torch.no_grad():
        pv = list(B._camera_params(cam, packed.lights))
        tri_geo, _, sph_geo, _ = B._prep_soft_arrays(packed)
        te = torch.tensor(tau_e, dtype=torch.float32, device=packed.device)
        tests = ([(B._tri_chunk_soft, tri_geo, c)
                  for c in range(-(-packed.n_tris // B.CK))]
                 + [(B._sph_chunk_soft, sph_geo, c)
                    for c in range(-(-packed.n_spheres // B.CK))])
        out = []
        for p0 in range(0, h * w, 65536):
            flat = torch.arange(p0, min(p0 + 65536, h * w), device=packed.device)
            yi = flat // w
            x = (flat - yi * w).to(torch.float32)[:, None]
            o, d = B._ray_bundle(pv, x, yi.to(torch.float32)[:, None], cam.normalize)
            bacc = torch.zeros_like(x)
            for test, geo, c in tests:
                cov = test(geo, c, o, d, te)[1]
                bacc = bacc + torch.log1p(-cov.clamp(0.0, 1.0 - 1e-6)).sum(1, keepdim=True)
            out.append(1.0 - torch.exp(bacc) != 0.0)
        return torch.cat(out).reshape(h, w)


def b1_bound(args, kw):
    """B1's bound (B2's for a float frame) from one frame's data, `args` and
    `kw` as `fwd_tiled.kernel_inputs` gives them: (bound_ms, bound_by,
    operations, lit pixels, occluded pixels). Every pixel of a non-empty
    tile tests the tile's primary candidates; a lit pixel is shaded once per
    light; an unoccluded lit pixel tests all of its tile's shadow
    candidates, an occluded one (it differs from the frame rendered without
    shadows) needs one test. (A pinhole frame is counted with the affine
    tests' operations: a floor.) Bytes, each read or written once: params,
    the counts, the real rows of the non-empty tiles (16 + 8 floats a
    candidate, 16 an occluder; a pinhole frame's occluder rows are one table
    for all tiles, read once), and the frame: 4 B a pixel packed, 16 B
    float."""
    from opencl_ray_tracer_tpu_torch.kernels import fwd_tiled

    h, w = kw["height"], kw["width"]
    counts = args[1]
    cnt = counts.long()
    nty, ntx = cnt.shape[0] // kw["ntx"], kw["ntx"]
    fkw = {**kw, "out_format": "float"}
    frame = fwd_tiled.tiled_kernel(*args, **fkw)
    nonempty = (cnt[:, 0] + cnt[:, 1]) > 0
    inside = per_tile(torch.ones((h, w), dtype=torch.bool, device=frame.device),
                      nty, ntx)
    ops = (inside * nonempty * (cnt[:, 0] * OPS["tri_affine"]
                                + cnt[:, 1] * OPS["sph_affine"])).sum()
    lit_mask = (frame[..., :3] > 0).any(-1)
    lit_t = per_tile(lit_mask, nty, ntx)
    n_occ = 0
    n_l = (cnt.shape[1] - 2) // 2
    if kw["shading"] != "legacy":
        ops = ops + lit_t.sum() * (OPS["shade_fixed"] + n_l * OPS["shade_light"])
        if kw["shadows"]:
            unshadowed = fwd_tiled.tiled_kernel(*args, **{**fkw, "shadows": False})
            occluded = lit_mask & (frame != unshadowed).any(-1)
            occ_t = per_tile(occluded, nty, ntx)
            n_occ = int(occluded.sum())
            for li in range(n_l):
                ops = ops + ((lit_t - occ_t) * (cnt[:, 2 + 2 * li] * OPS["sh_tri_planes"]
                                                + cnt[:, 3 + 2 * li] * OPS["sh_sph"])).sum()
                ops = ops + occ_t.sum() * OPS["sh_sph"]
    sh = cnt[:, 2:].sum(1)
    sh = sh[:1] * nonempty.any() if kw["projective"] else sh * nonempty
    n_bytes = (nbytes(args[0], counts) + int(((cnt[:, 0] + cnt[:, 1]) * nonempty).sum()) * 96
               + int(sh.sum()) * 64 + h * w * (4 if kw["out_format"] == "packed" else 16))
    return bound(float(ops), n_bytes) + (float(ops), int(lit_mask.sum()), n_occ)


def tiled_soft_bounds(scene, cam, cfg, operands, g):
    """(B4's bound, B5's bound for the cotangent g, pixels in non-empty
    tiles, covered pixels, pixels with a cotangent), each bound with its
    operations behind it; `operands` as `soft_tiled.soft_kernel_inputs`
    gives them; counted as `brute_soft_bounds` counts. B4: every pixel of a
    non-empty tile streams the tile's processed candidate rows; only a
    covered pixel (1 - w_bg != 0) needs the finish, the shading and the
    walk over the processed occluder rows of every light. B5: a pixel whose
    cotangent is zero (or whose tile is empty) needs nothing; every other
    needs its whole forward once and the reverse of its primary tests; the
    reverse of the finish, the shading and the occluders only where the
    pixel is covered. (A pinhole frame is counted with the affine tests'
    operations: a floor.)

    Bytes, each read or written once. Both read params, taus and the
    counts. B4 reads the real rows (the counts') of its non-empty tiles and
    writes the frame. B5 reads the cotangent in the non-empty tiles only
    (an empty tile's gradient is zero whatever g holds there), the real
    rows of the tiles that hold a non-zero cotangent, and writes every
    gradient table, params and taus row once.

    In the stored-finals regime (the operands' cfg "stored_finals") the two
    functions are the same, and so is their work: the count above charges
    B5 one forward a pixel, which the block provides in place of B5's own
    first pass, while the primary tests' and the occluder tests' forward
    still has to be done inside their reverse. Only bytes are added: B4
    writes, and B5 reads for each pixel with a cotangent, the block's rows
    of the pixel (`soft_tiled.finals_layout`, 4 B each; the logvis rows
    only where the pixel is covered)."""
    from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S

    params, taus, tables, counts, kc = operands
    h, w = cfg.height, cfg.width
    cnt = counts.long()
    proc = (cnt + S.CH - 1) // S.CH * S.CH
    nonempty = (cnt[:, 0] + cnt[:, 1]) > 0
    covered_px = soft_covered(scene.pack(), cam, cfg.tau_edge, h, w)
    has_cot = (g[..., :3] != 0).any(-1)
    tile_sums = lambda m: per_tile(m, kc["nty"], kc["ntx"]) * nonempty  # noqa: E731
    live = tile_sums(torch.ones((h, w), dtype=torch.bool, device=g.device))
    covered, cot = tile_sums(covered_px), tile_sums(has_cot)
    both = tile_sums(has_cot & covered_px)
    n_l = kc["n_lights"]

    def per_px(ops):
        prim = proc[:, 0] * ops["soft_tri_affine"] + proc[:, 1] * ops["soft_sph_affine"]
        rest = ops["soft_finish"] + n_l * ops["soft_light"]
        for li in range(n_l):
            rest = rest + (proc[:, 2 + 2 * li] * ops["occ_tri"]
                           + proc[:, 3 + 2 * li] * ops["occ_sph"])
        return prim, rest

    def row_bytes(tiles):
        """Bytes of the real rows of the tiles in the (n_tiles,) mask: 16 + 8
        floats a candidate, 16 an occluder; a pinhole frame's occluder rows
        are one table for all tiles, read once if any tile is in the mask."""
        sh = cnt[:, 2:].sum(1)
        sh = sh[:1] * tiles.any() if kc["projective"] else (sh * tiles).sum()
        return int(((cnt[:, 0] + cnt[:, 1]) * tiles).sum()) * 96 + int(sh) * 64

    prim_f, rest_f = per_px(OPS)
    prim_b, rest_b = per_px(OPS_BWD)
    ops_b4 = float((live * prim_f + covered * rest_f).sum())
    ops_b5 = float((cot * (prim_f + rest_f + prim_b) + both * rest_b).sum())
    small = nbytes(params, taus, counts)
    bytes_b4 = small + row_bytes(nonempty) + h * w * 16
    bytes_b5 = (small + int(live.sum()) * 16 + row_bytes(cot > 0)
                + nbytes(params, taus, *tables))
    if kc.get("stored_finals", False):
        layout = [name for name, _ in S.finals_layout(kc)]
        n_lv = sum(name.startswith("logvis") for name in layout)
        n_base = len(layout) - n_lv
        bytes_b4 += 4 * int((live * n_base + covered * n_lv).sum())
        bytes_b5 += 4 * int((cot * n_base + both * n_lv).sum())
    return (bound(ops_b4, bytes_b4) + (ops_b4,),
            bound(ops_b5, bytes_b5) + (ops_b5,),
            int(live.sum()), int(covered.sum()), int(cot.sum()))


def brute_soft_bounds(scene, cam, cfg, inputs, g):
    """(B6's bound, B7's bound for the cotangent g, covered pixels, pixels
    with a cotangent), each bound with its operations behind it. B6: every
    pixel streams every primitive; only a covered pixel (1 - w_bg != 0: the
    others are 0 whatever their shading) needs the finish, the shading and,
    per light, the walk over every primitive as an occluder. B7: a pixel
    whose cotangent is zero needs nothing; every other needs its whole
    forward once (d out / d w_bg is the shaded colour) and the reverse of
    its primary tests; the reverse of the finish, the shading and the
    occluders only where the pixel is covered (elsewhere their cotangents
    are exactly zero). Bytes: B6 reads its inputs and writes the frame, B7
    reads its inputs and the cotangent and writes one gradient an input."""
    packed = scene.pack()
    n_t, n_s = packed.n_tris, packed.n_spheres
    n_l = packed.lights.position.shape[0]
    n_pix = cfg.height * cfg.width
    covered = soft_covered(packed, cam, cfg.tau_edge, cfg.height, cfg.width)
    has_cot = (g[..., :3] != 0).any(-1)
    n_cov, n_cot = int(covered.sum()), int(has_cot.sum())
    n_both = int((covered & has_cot).sum())

    def per_px(ops):
        return (n_t * ops["soft_tri_general"] + n_s * ops["soft_sph_general"],
                ops["soft_finish"] + n_l * ops["soft_light"]
                + n_l * (n_t * ops["occ_tri"] + n_s * ops["occ_sph"]))

    prim_f, rest_f = per_px(OPS)
    prim_b, rest_b = per_px(OPS_BWD)
    ops_b6 = n_pix * prim_f + n_cov * rest_f
    ops_b7 = n_cot * (prim_f + rest_f + prim_b) + n_both * rest_b
    in_bytes = nbytes(*inputs)
    return (bound(ops_b6, in_bytes + n_pix * 16) + (ops_b6,),
            bound(ops_b7, 2 * in_bytes + n_pix * 16) + (ops_b7,), n_cov, n_cot)


def b3_bound(args, kw):
    """B3's bound for one frame, `args` and `kw` as
    `fwd.brute_kernel_inputs` gives them: (bound_ms, bound_by, operations,
    lit pixels, occluded pixels). Every pixel tests every real primitive
    (the affine tests, or the general ones through a pinhole camera); a lit
    pixel is shaded; an unoccluded lit pixel walks every primitive per light
    (general tests), an occluded one (it differs from the frame rendered
    without shadows) needs one test. Bytes: the inputs once, the float frame
    once."""
    from opencl_ray_tracer_tpu_torch.kernels import fwd

    frame = fwd.brute_kernel(*args, **kw)
    n_pix = kw["height"] * kw["width"]
    n_t, n_s = kw["n_tris"], kw["n_spheres"]
    n_l = (args[0].numel() - 21) // 7
    kind = "general" if kw["normalize_dir"] else "affine"
    ops = n_pix * (n_t * OPS[f"tri_{kind}"] + n_s * OPS[f"sph_{kind}"])
    lit_mask = (frame[..., :3] != 0).any(-1)
    n_lit, n_occ = int(lit_mask.sum()), 0
    if kw["shading"] != "legacy":
        ops += n_lit * (OPS["shade_fixed"] + n_l * OPS["shade_light"])
        if kw["shadows"]:
            unshadowed = fwd.brute_kernel(*args, **{**kw, "shadows": False})
            n_occ = int((lit_mask & (frame != unshadowed).any(-1)).sum())
            ops += n_l * ((n_lit - n_occ) * (n_t * OPS["tri_general"]
                                             + n_s * OPS["sph_general"])
                          + n_occ * OPS["sph_general"])
    return bound(ops, nbytes(*args) + n_pix * 16) + (ops, n_lit, n_occ)


def rays_per_second(n_pixels: int, frame_ms: float) -> float:
    return n_pixels / (frame_ms / 1e3)


def sol_fraction(device_ms: float, bound_ms: float, bound_by: str) -> dict:
    """Speed of light of one measured call against its H100 bound:
    {"bound": what bounds it, "ideal_ms": the bound, "achieved_fraction":
    bound / measured}."""
    return {"bound": bound_by, "ideal_ms": bound_ms,
            "achieved_fraction": bound_ms / device_ms if device_ms > 0 else 0.0}


def device_kind() -> Optional[str]:
    """The card's name, or None without one."""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else None


def device_profile(fn, n):
    """Device kernels per call, the device's busy share of the wall time
    (the union of kernel intervals), device ms per call (that union over
    n: the card's own time for a call, whatever the host does between its
    launches), and the six kernel names with the most device time per call
    (ms), from a torch.profiler trace of n calls on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the profiler saw no device work")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (len(spans) / n, busy / wall_us, busy / n / 1e3,
            [(name[:60], us / n / 1e3) for name, us in top])


# Each hand-written kernel's function name in kernels/csrc/, as a profiler
# trace of a call shows it (B1 and B2 are one kernel with an output switch).
KERNEL_NAMES = {"B1/B2": "fwd_tiled_kernel", "B3": "fwd_brute_kernel",
                "B4": "soft_fwd_kernel", "B5": "soft_bwd_kernel",
                "B6": "soft_brute_fwd_kernel", "B7": "soft_brute_bwd_kernel"}


def trace_ops(fn):
    """The names of the device operations (kernels, copies, fills) of one
    call of `fn` on the card, from a torch.profiler trace; a first call runs
    untraced (a graph's capture, a library's build). The names of kernels
    inside a graph's conditional nodes are wrong once the process holds
    graphs of several shapes (torch 2.11, CUDA 12.8): trace those in a
    process of their own (chip_smoke.py `_branch_traces`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernels_in(names) -> set:
    """The keys of KERNEL_NAMES whose kernel is among the operation names
    (demangled, or mangled with a length before and a type after)."""
    return {k for k, fn in KERNEL_NAMES.items()
            if any(re.search(rf"(?<![A-Za-z_]){fn}(?![a-z0-9_])", n)
                   for n in names)}
