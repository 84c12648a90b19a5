"""What a frame or a fit step needs, counted from its inputs.

The unit costs are counted from the expressions of the port's kernel sources
(kernels/csrc/, as `utils/profiling.OPS` and `OPS_BWD` of the port tabulate
them; kept here as they stand): every add, multiply, compare, select,
min / max, divide, sqrt, exp, log and log1p counts one. What a frame needs is
a floor whatever implements it:

- hard frame (B1/B2): each pixel tests the primitives its ray hits (a ray
  must meet each of them to find the nearest); a lit pixel is shaded once
  and once a light; a pixel in shadow needs one occluder test a light that
  is blocked. Bytes: the scene's rows once, the frame once (4 B a pixel
  packed, 16 B float).
- soft forward (B4): each pixel streams the primitives whose coverage there
  is above 1e-12 (the softmax keeps no other); a covered pixel
  (1 - w_bg != 0) also needs the finish, the shading a light and the
  occluders whose occlusion is above 1e-12. Bytes: the scene once, the
  float frame once.
- soft backward (B5): a pixel whose cotangent is zero needs nothing; every
  other needs its forward once and the reverse of its primary tests; the
  reverse of the finish, the shading and the occluders only where it is
  covered. Bytes: the scene once, the cotangent once, one gradient a scene
  value.

The per-pixel counts come from the reference (`reference.hard.render` and
`reference.soft.render` with counts), so they follow the data and nothing
else."""

from __future__ import annotations

OPS = {
    "tri_affine": 19, "sph_affine": 22, "tri_general": 53, "sph_general": 23,
    "sh_tri_planes": 76, "sh_sph": 24,
    "shade_fixed": 40, "shade_light": 45,
    "soft_tri_affine": 77, "soft_sph_affine": 100,
    "soft_tri_general": 120, "soft_sph_general": 101,
    "occ_tri": 87, "occ_sph": 64,
    "soft_finish": 60, "soft_light": 70,
}
OPS_BWD = {
    "soft_tri_affine": 120, "soft_sph_affine": 169,
    "soft_tri_general": 225, "soft_sph_general": 176,
    "occ_tri": 189, "occ_sph": 119,
    "soft_finish": 239, "soft_light": 171,
}

SCENE_FLOATS = {"tri": 9 + 4, "sph": 3 + 1 + 4}


def scene_bytes(n_tris: int, n_spheres: int, n_lights: int) -> int:
    return 4 * (n_tris * SCENE_FLOATS["tri"] + n_spheres * SCENE_FLOATS["sph"]
                + n_lights * 7 + 3)


def hard_frame(counts: dict, *, n_tris: int, n_spheres: int, n_lights: int,
               shading: str, projective: bool, out_format: str):
    """(ops, bytes) of one hard frame from `reference.hard.render`'s counts
    ("pairs": primary hit pairs a pixel, "lit", "occluded")."""
    kind = "general" if projective else "affine"
    # a hit pair is charged the cheaper of the two tests: a floor
    test = min(OPS[f"tri_{kind}"], OPS[f"sph_{kind}"])
    ops = float(counts["pairs"].sum()) * test
    n_lit = float(counts["lit"].sum())
    if shading != "legacy":
        ops += n_lit * (OPS["shade_fixed"] + n_lights * OPS["shade_light"])
        ops += float(counts["occluded"].sum()) * OPS["sh_sph"]
    h, w = counts["lit"].shape
    nbytes = scene_bytes(n_tris, n_spheres, n_lights) + h * w * (
        4 if out_format == "packed" else 16)
    return ops, nbytes


def soft_step(counts: dict, cot_mask, *, n_tris: int, n_spheres: int,
              n_lights: int, projective: bool):
    """((B4 ops, bytes), (B5 ops, bytes)) of one soft step from
    `reference.soft.render`'s counts ("tri", "sph", "covered",
    "occ_tri", "occ_sph": per pixel) and the (H, W) mask of pixels whose
    cotangent is not zero."""
    kind = "general" if projective else "affine"
    tri = counts.get("tri")
    sph = counts.get("sph")
    cov = counts["covered"]
    h, w = cov.shape

    def prim(table):
        p = 0.0
        if tri is not None:
            p = p + tri.double() * table[f"soft_tri_{kind}"]
        if sph is not None:
            p = p + sph.double() * table[f"soft_sph_{kind}"]
        return p

    def rest(table):
        r = table["soft_finish"] + n_lights * table["soft_light"]
        for k in ("tri", "sph"):
            if f"occ_{k}" in counts:
                r = r + counts[f"occ_{k}"].double() * table[f"occ_{k}"]
        return r

    pf, pb = prim(OPS), prim(OPS_BWD)
    rf, rb = rest(OPS), rest(OPS_BWD)
    covf = cov.double()
    cot = cot_mask.double()
    ops4 = float((pf + covf * rf).sum())
    ops5 = float((cot * (pf + covf * rf + pb) + cot * covf * rb).sum())
    sb = scene_bytes(n_tris, n_spheres, n_lights)
    b4 = sb + h * w * 16
    b5 = sb + h * w * 16 + sb
    return (ops4, b4), (ops5, b5)
