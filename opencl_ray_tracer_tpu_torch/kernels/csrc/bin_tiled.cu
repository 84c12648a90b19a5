// Tile binning and the per-frame coefficient gather of the tiled hard frame,
// and the tile binning of the tiled soft frame, for Hopper (sm_90a): the
// tables that B1/B2 (fwd_tiled.cu) read and the lists that the soft frame's
// table gather (soft_tiled.py _gather_soft_tables) reads for B4/B5.
//
// Replaces no Pallas kernel: the JAX package bins and gathers in XLA ops
// (opencl_ray_tracer_tpu/kernels/fwd_tiled.py: bin_scene, _gather_coefs;
// soft_tiled.py: _bin_soft). In the port those were some 320 small PyTorch
// kernels a hard frame and 430 a soft train step, each a launch of a few
// microseconds over a few kilobytes, so the chain of launches, not the
// arithmetic, set the pace of a replayed frame or step. The plain PyTorch
// twins are opencl_ray_tracer_tpu_torch/kernels/fwd_tiled.py:
// _bin_scene_plain (bin_prep_kernel + bin_tiles_kernel) and the CPU branch
// of kernel_inputs (gather_kernel), and kernels/soft_tiled.py:
// _bin_soft_plain (bin_soft_prep_kernel + bin_soft_tiles_kernel); the
// arithmetic is theirs, in their order.
//
// What it computes:
//   - bin_prep_kernel, one thread a padded primitive: its screen box (ortho:
//     _prim_bboxes, with the camera's origin offset applied to the tiles;
//     pinhole: _pinhole_bboxes, the whole screen for a primitive that
//     reaches behind the near plane) and padded z extent (_prim_z_extents);
//     each light's frustum planes of a triangle (_tri_shadow_planes) into
//     the shared pinhole table or the ortho scratch; the pinhole sphere
//     occluder rows (padded spheres nulled); it clears the overflow flag;
//   - bin_tiles_kernel, one block a tile: the first K primitives whose box
//     overlaps the tile, in ascending order (the set and order of
//     _bin_prims' top-k over unique scores), their count clamped to K and
//     the overflow flag where a count passes K; the tile's hit-z slab
//     (_tile_hit_z); the ortho segment-hull shadow lists of every light as
//     table rows; the counts row [tri, sph, (sh_tri, sh_sph) per light];
//     the attribute rows of the primary lists (_prep_scene_arrays' rows);
//   - gather_kernel, one block a tile: B1's params vector (_camera_params)
//     and its affine (fwd.py _prep_affine_coefs) or projective
//     (_prep_projective_coefs) coefficient rows of each listed primitive,
//     null rows past each list (_gather_coefs);
//   - bin_soft_prep_kernel, one thread a padded primitive: its screen box
//     padded by SOFT_CULL_SIGMAS * tau_edge, read from the card (ortho:
//     _prim_bboxes then _pad_box; pinhole: _pinhole_bboxes_soft, the
//     projected corners of the padded AABB), its z extent padded by that
//     pad + SHADOW_OFFSET (_prim_z_extents); it clears the overflow flag;
//   - bin_soft_tiles_kernel, one block a tile: the primary lists and the
//     hit-z slab as bin_tiles_kernel makes them (tile_primaries), each
//     light's ortho segment-hull shadow lists as index lists (SoftBins'
//     tsh_idx, ssh_idx and their valid masks), the counts row and the
//     overflow flag. A pinhole frame's shadow candidates are the whole
//     primitive set, which the table gather lays out itself: its lists are
//     empty and its counts the primitive counts.
//
// What bounds it on this card: neither bytes nor operations. At the 1080p
// headline frame the tables are ~0.3 MB and the tests a few hundred
// thousand operations, microseconds at the card's rates; the three launches
// and the chains of dependent loads inside a block set the time. So the
// design keeps the launches few and each block's chain short:
//   - a list is one warp's scan over the primitives in chunks of 32:
//     each lane tests one, __ballot_sync and a prefix count give each hit
//     its slot, so the indices come out in ascending order with no sort and
//     no barrier; the scan stops once the count passes K (the count is
//     clamped to K and the flag is all the rest need);
//   - a tile's lists (two primary, then 2 L shadow lists over its warps) and
//     rows are written by its own block, with two block barriers;
//   - nothing is allocated or synchronised here: the wrappers allocate, and
//     the launches capture into a CUDA graph as they stand.
//
// Numerics: built with -fmad=false and IEEE division and square root, as the
// other sources, so each product, sum and quotient rounds once as in the
// float32 twin. The lists come from comparisons of the same values and equal
// the twin's; the pinhole box inverts the camera matrix in double (the twin's
// LAPACK inverse and matrix product round elsewhere, within a few ulps), and
// sums of three products are taken left to right. Two of the twin's ops are
// compiled in PyTorch with a fused multiply-add, and are written here with
// __fmaf_rn as they are computed there: each component a_i b_j - a_j b_i of
// torch.linalg.cross as fma(a_i, b_j, -(a_j b_i)), and the sum of squares
// of torch.linalg.vector_norm as fma(z, z, fma(y, y, x x)). Unfused, the
// coefficient rows built from a cross product (q = (o - v0) x e1) leave the
// twin's by an ulp, and the hard frame drawn from them flips edge pixels.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

#define HD __device__ __forceinline__

namespace octrt_bin {

constexpr int TILE_H = 64;
constexpr int TILE_W = 128;
constexpr float Z_PAD = 0.1f;        // bin_scene's z_pad
constexpr float BOX_PAD = 1e-3f;     // _prim_bboxes' pad
constexpr float PIN_PAD = 1.0f;      // _pinhole_bboxes' pad
constexpr float PIN_BIG = 1e9f;      // _pinhole_bboxes' whole-screen box
constexpr float SLAB_BIG = 1e30f;    // _tile_hit_z's empty slab
constexpr float EPSILON = 1e-6f;     // ops/intersect.py EPSILON
constexpr float SOFT_CULL_SIGMAS = 16.0f;  // soft_tiled.py SOFT_CULL_SIGMAS
constexpr float SHADOW_OFFSET = 1e-2f;     // diff/soft.py SHADOW_OFFSET

// params layout (kernels/fwd.py _P_*)
constexpr int P_LIGHTS = 21, LIGHT_STRIDE = 7;

struct V3 {
  float x, y, z;
};

HD V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
HD V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
HD V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
HD V3 cross(V3 a, V3 b) {  // torch.linalg.cross
  return {__fmaf_rn(a.y, b.z, -(a.z * b.y)), __fmaf_rn(a.z, b.x, -(a.x * b.z)),
          __fmaf_rn(a.x, b.y, -(a.y * b.x))};
}
HD float norm3(V3 a) {  // torch.linalg.vector_norm
  return sqrtf(__fmaf_rn(a.z, a.z, __fmaf_rn(a.y, a.y, a.x * a.x)));
}
HD float min3(float a, float b, float c) { return fminf(fminf(a, b), c); }
HD float max3(float a, float b, float c) { return fmaxf(fmaxf(a, b), c); }
HD V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

// Column i of a (3, n) row-major array: the packed scene's layout.
HD V3 col3(const float* a, int n, int i) { return {a[i], a[n + i], a[2 * n + i]}; }

// Screen box (x0, x1, y0, y1) and z extent (z0, z1) of one primitive.
struct Box {
  float x0, x1, y0, y1;
};

// _prim_bboxes
HD Box tri_box_ortho(V3 v0, V3 v1, V3 v2) {
  return {min3(v0.x, v1.x, v2.x) - BOX_PAD, max3(v0.x, v1.x, v2.x) + BOX_PAD,
          min3(v0.y, v1.y, v2.y) - BOX_PAD, max3(v0.y, v1.y, v2.y) + BOX_PAD};
}

HD Box sph_box_ortho(V3 c, float r) {
  const float rr = r + BOX_PAD;
  return {c.x - rr, c.x + rr, c.y - rr, c.y + rr};
}

// The pinhole projection: M^-1 with M = [ddx | ddy | d0] (columns), and the
// camera's origin. A world point P maps to [x*k, y*k, k] = M^-1 (P - o).
struct Proj {
  float m[9];  // row-major
  V3 o;
};

HD Proj make_proj(const float* ddx, const float* ddy, const float* d0,
                  const float* o0) {
  const double a = ddx[0], b = ddy[0], c = d0[0];
  const double d = ddx[1], e = ddy[1], f = d0[1];
  const double g = ddx[2], h = ddy[2], i = d0[2];
  const double A = e * i - f * h, B = f * g - d * i, C = d * h - e * g;
  const double det = a * A + b * B + c * C;
  const double adj[9] = {A, c * h - b * i, b * f - c * e,
                         B, a * i - c * g, c * d - a * f,
                         C, b * g - a * h, a * e - b * d};
  Proj p;
  for (int k = 0; k < 9; ++k) p.m[k] = (float)(adj[k] / det);
  p.o = load3(o0);
  return p;
}

// _pinhole_bboxes' box of n corner points: the bbox of their projections,
// padded, or the whole screen where any corner is at or behind the near
// plane.
struct ProjBox {
  float x0 = 0.0f, x1 = 0.0f, y0 = 0.0f, y1 = 0.0f;
  bool ok = true, first = true;

  HD void corner(const Proj& P, V3 c) {
    const V3 q = sub(c, P.o);
    const float vx = P.m[0] * q.x + P.m[1] * q.y + P.m[2] * q.z;
    const float vy = P.m[3] * q.x + P.m[4] * q.y + P.m[5] * q.z;
    const float w = P.m[6] * q.x + P.m[7] * q.y + P.m[8] * q.z;
    const bool front = w > 1e-6f;
    const float sw = front ? w : 1.0f;
    const float sx = vx / sw, sy = vy / sw;
    ok = ok && front;
    x0 = first ? sx : fminf(x0, sx);
    x1 = first ? sx : fmaxf(x1, sx);
    y0 = first ? sy : fminf(y0, sy);
    y1 = first ? sy : fmaxf(y1, sy);
    first = false;
  }

  HD Box box() const {
    if (!ok) return {-PIN_BIG, PIN_BIG, -PIN_BIG, PIN_BIG};
    return {x0 - PIN_PAD, x1 + PIN_PAD, y0 - PIN_PAD, y1 + PIN_PAD};
  }
};

HD Box tri_box_proj(const Proj& P, V3 v0, V3 v1, V3 v2) {
  ProjBox b;
  b.corner(P, v0);
  b.corner(P, v1);
  b.corner(P, v2);
  return b.box();
}

HD Box sph_box_proj(const Proj& P, V3 c, float r) {
  ProjBox b;
  for (int k = 0; k < 8; ++k) {  // the AABB's corners, c + r * (+-1, +-1, +-1)
    b.corner(P, {c.x + ((k & 4) ? r : -r), c.y + ((k & 2) ? r : -r),
                 c.z + ((k & 1) ? r : -r)});
  }
  return b.box();
}

// _pad_box: a screen box grown by pad on every side.
HD Box pad_box(Box b, float pad) { return {b.x0 - pad, b.x1 + pad, b.y0 - pad, b.y1 + pad}; }

// _pinhole_bboxes_soft's box_of_aabb: the projected corners of the AABB
// [lo, hi] grown by pad world units, as centre +- (half extent + pad).
HD Box aabb_box_proj(const Proj& P, V3 lo, V3 hi, float pad) {
  const V3 ctr = {0.5f * (lo.x + hi.x), 0.5f * (lo.y + hi.y), 0.5f * (lo.z + hi.z)};
  const V3 half = {0.5f * (hi.x - lo.x) + pad, 0.5f * (hi.y - lo.y) + pad,
                   0.5f * (hi.z - lo.z) + pad};
  ProjBox b;
  for (int k = 0; k < 8; ++k) {  // _AABB_SIGNS' order
    b.corner(P, {ctr.x + ((k & 4) ? half.x : -half.x), ctr.y + ((k & 2) ? half.y : -half.y),
                 ctr.z + ((k & 1) ? half.z : -half.z)});
  }
  return b.box();
}

// _axis_s_interval: the feasible s-interval [lo, hi] (when ok) of one axis of
// the segment-hull test, tile hit box [b0, b1], light at L, occluder [o0, o1].
struct Interval {
  float lo, hi;
  bool ok;
};

HD Interval axis_s(float b0, float b1, float L, float o0, float o1) {
  const float eps = 1e-12f, big = 1e30f;
  const float dA = L - b0, rA = o1 - b0;
  const float hiA = dA > eps ? rA / dA : big;
  const float loA = dA < -eps ? rA / dA : -big;
  const bool okA = fabsf(dA) <= eps ? rA >= 0.0f : true;
  const float dB = L - b1, rB = o0 - b1;
  const float loB = dB > eps ? rB / dB : -big;
  const float hiB = dB < -eps ? rB / dB : big;
  const bool okB = fabsf(dB) <= eps ? rB <= 0.0f : true;
  return {fmaxf(loA, loB), fminf(hiA, hiB), okA && okB};
}

// A tile's rect in the binning's coordinates and its hit-z slab.
struct Rect {
  float x0, x1, y0, y1, z0, z1;
};

HD bool box_overlap(const Rect& t, const Box& b) {
  return b.x0 <= t.x1 && b.x1 >= t.x0 && b.y0 <= t.y1 && b.y1 >= t.y0;
}

// _bin_prims' segment-hull test: the occluder's box (b, z0, z1) meets the
// convex hull of the tile's hit box and the light point L.
HD bool hull_overlap(const Rect& t, V3 L, const Box& b, float z0, float z1) {
  const Interval X = axis_s(t.x0, t.x1, L.x, b.x0, b.x1);
  const Interval Y = axis_s(t.y0, t.y1, L.y, b.y0, b.y1);
  const Interval Z = axis_s(t.z0, t.z1, L.z, z0, z1);
  const float lo = fmaxf(fmaxf(X.lo, Y.lo), fmaxf(Z.lo, 0.0f));
  const float hi = fminf(fminf(X.hi, Y.hi), fminf(Z.hi, 1.0f));
  return lo <= hi && X.ok && Y.ok && Z.ok;
}

// _norm_rows for one row: m / max(|m|, 1e-20), and |m|.
HD V3 unit(V3 m, float& mag) {
  mag = norm3(m);
  const float d = fmaxf(mag, 1e-20f);
  return {m.x / d, m.y / d, m.z / d};
}

// One side plane of _tri_shadow_planes: (m, c) into row[0, 4).
HD void side_plane(V3 vi, V3 vj, V3 vk, V3 L, float* row) {
  float mag;
  V3 m = unit(cross(sub(vj, vi), sub(L, vi)), mag);
  const float s_k = dot(m, sub(vk, vi));
  m = scale(m, s_k < 0.0f ? -1.0f : 1.0f);
  const float c = -dot(m, vi);
  const bool degen = fabsf(s_k) < 1e-9f || mag < 1e-12f;
  row[0] = m.x;
  row[1] = m.y;
  row[2] = m.z;
  row[3] = degen ? -1e9f : c;
}

// _tri_shadow_planes: a triangle's 16-float light-frustum row for light L.
HD void tri_planes(V3 v0, V3 e1, V3 e2, V3 L, float* row) {
  const V3 v1 = add(v0, e1), v2 = add(v0, e2);
  side_plane(v0, v1, v2, L, row);
  side_plane(v1, v2, v0, L, row + 4);
  side_plane(v2, v0, v1, L, row + 8);
  float nmag;
  V3 n = unit(cross(e1, e2), nmag);
  const float s_l = dot(n, sub(L, v0));
  n = scale(n, s_l > 0.0f ? -1.0f : 1.0f);
  const float cp = -dot(n, v0);
  const bool degen = fabsf(s_l) < 1e-9f || nmag < 1e-12f;
  row[12] = n.x;
  row[13] = n.y;
  row[14] = n.z;
  row[15] = degen ? -1e9f : cp;
}

// _sph_shadow_rows: [cx, cy, cz, r^2, 0...]; the null rows of fwd_tiled.py.
HD void sph_row(V3 c, float r, float* row) {
  for (int k = 0; k < 16; ++k) row[k] = 0.0f;
  row[0] = c.x;
  row[1] = c.y;
  row[2] = c.z;
  row[3] = r * r;
}

HD void null_sh_tri(float* row) {  // _NULL_SH_TRI: every plane fails
  for (int k = 0; k < 16; ++k) row[k] = (k & 3) == 3 ? -1e9f : 0.0f;
}

HD void null_sh_sph(float* row) {  // _NULL_SH_SPH: z = 1e9, r2 = 0
  for (int k = 0; k < 16; ++k) row[k] = k == 2 ? 1e9f : 0.0f;
}

// The packed scene: (3, tp) triangle arrays, (3 | 1 | 4, sp) sphere arrays.
struct Prims {
  const float *tri_v0, *tri_e1, *tri_e2, *tri_colour;
  const float *sph_origin, *sph_radius, *sph_colour;
  int tp, sp, n_tris, n_sph;

  HD V3 v0(int p) const { return col3(tri_v0, tp, p); }
  HD V3 e1(int p) const { return col3(tri_e1, tp, p); }
  HD V3 e2(int p) const { return col3(tri_e2, tp, p); }
  HD V3 centre(int s) const { return col3(sph_origin, sp, s); }
};

// _prep_scene_arrays' attribute rows: [r, g, b, unit normal, 0, 0] and
// [r, g, b, centre, 1/r (0 for r = 0), 1].
HD void tri_attr(const Prims& s, int p, float* row) {
  const V3 n = cross(s.e1(p), s.e2(p));
  const float d = fmaxf(norm3(n), 1e-20f);
  row[0] = s.tri_colour[p];
  row[1] = s.tri_colour[s.tp + p];
  row[2] = s.tri_colour[2 * s.tp + p];
  row[3] = n.x / d;
  row[4] = n.y / d;
  row[5] = n.z / d;
  row[6] = 0.0f;
  row[7] = 0.0f;
}

HD void sph_attr(const Prims& s, int q, float* row) {
  const V3 c = s.centre(q);
  const float r = s.sph_radius[q];
  row[0] = s.sph_colour[q];
  row[1] = s.sph_colour[s.sp + q];
  row[2] = s.sph_colour[2 * s.sp + q];
  row[3] = c.x;
  row[4] = c.y;
  row[5] = c.z;
  row[6] = r > 0.0f ? 1.0f / r : 0.0f;
  row[7] = 1.0f;
}

// The camera's affine ray bundle.
struct Cam {
  V3 o0, dox, doy, d0, ddx, ddy;
};

// fwd.py _prep_affine_coefs' rows, padded to 16: triangle [u0, ux, uy, v0,
// vx, vy, t0, tx, ty] (u0 = -1e9 where |det| < EPSILON), sphere [tca0,
// tcax, tcay, d20, d2x, d2y, d2xx, d2yy, d2xy, r2].
HD void tri_coef_affine(const Cam& c, V3 v0, V3 e1, V3 e2, float* row) {
  const V3 pvec = cross(c.d0, e2);
  const float det = dot(e1, pvec);
  const bool ok = fabsf(det) >= EPSILON;
  const float inv = ok ? 1.0f / det : 0.0f;
  const V3 base = sub(c.o0, v0);
  const V3 q0 = cross(base, e1), qx = cross(c.dox, e1), qy = cross(c.doy, e1);
  for (int k = 9; k < 16; ++k) row[k] = 0.0f;
  row[0] = ok ? dot(base, pvec) * inv : -1e9f;
  row[1] = dot(c.dox, pvec) * inv;
  row[2] = dot(c.doy, pvec) * inv;
  row[3] = dot(c.d0, q0) * inv;
  row[4] = dot(c.d0, qx) * inv;
  row[5] = dot(c.d0, qy) * inv;
  row[6] = dot(e2, q0) * inv;
  row[7] = dot(e2, qx) * inv;
  row[8] = dot(e2, qy) * inv;
}

HD void sph_coef_affine(const Cam& c, V3 C, float r, float* row) {
  const float a = dot(c.dox, c.d0), b = dot(c.doy, c.d0);
  const V3 L0 = sub(C, c.o0);
  const float tca0 = dot(L0, c.d0);
  const float m0 = dot(L0, L0);
  const float mx = -2.0f * dot(L0, c.dox);
  const float my = -2.0f * dot(L0, c.doy);
  const float mxx = dot(c.dox, c.dox), myy = dot(c.doy, c.doy);
  const float mxy = 2.0f * dot(c.dox, c.doy);
  for (int k = 10; k < 16; ++k) row[k] = 0.0f;
  row[0] = tca0;
  row[1] = -a;
  row[2] = -b;
  row[3] = m0 - tca0 * tca0;
  row[4] = mx + 2.0f * tca0 * a;
  row[5] = my + 2.0f * tca0 * b;
  row[6] = mxx - a * a;
  row[7] = myy - b * b;
  row[8] = mxy - 2.0f * a * b;
  row[9] = r * r;
}

// fwd_tiled.py _prep_projective_coefs' rows, padded to 16: triangle [det0,
// detx, dety, un0, unx, uny, vn0, vnx, vny, tnum], sphere [tc0, tcx, tcy,
// L2, r2].
HD void tri_coef_proj(const Cam& c, V3 v0, V3 e1, V3 e2, float* row) {
  const V3 pv0 = cross(c.d0, e2), pvx = cross(c.ddx, e2), pvy = cross(c.ddy, e2);
  const V3 base = sub(c.o0, v0);
  const V3 q = cross(base, e1);
  for (int k = 10; k < 16; ++k) row[k] = 0.0f;
  row[0] = dot(e1, pv0);
  row[1] = dot(e1, pvx);
  row[2] = dot(e1, pvy);
  row[3] = dot(base, pv0);
  row[4] = dot(base, pvx);
  row[5] = dot(base, pvy);
  row[6] = dot(c.d0, q);
  row[7] = dot(c.ddx, q);
  row[8] = dot(c.ddy, q);
  row[9] = dot(e2, q);
}

HD void sph_coef_proj(const Cam& c, V3 C, float r, float* row) {
  const V3 L = sub(C, c.o0);
  for (int k = 5; k < 16; ++k) row[k] = 0.0f;
  row[0] = dot(L, c.d0);
  row[1] = dot(L, c.ddx);
  row[2] = dot(L, c.ddy);
  row[3] = dot(L, L);
  row[4] = r * r;
}

// The null coefficient rows of fwd_tiled.py (_NULL_TRI, _NULL_SPH,
// _NULL_TRI_PROJ, _NULL_SPH_PROJ), padded to 16: never valid in B1's tests.
HD void null_coef(bool tri, bool proj, float* row) {
  for (int k = 0; k < 16; ++k) row[k] = 0.0f;
  if (tri && !proj) {
    row[0] = -1e9f;
    row[3] = -1e9f;
  } else if (!tri && !proj) {
    row[0] = -1e9f;
    row[3] = 1e9f;
    row[9] = -1.0f;
  } else if (!tri) {
    row[0] = -1e9f;
    row[4] = -1.0f;
  }
}

}  // namespace octrt_bin

namespace {

using namespace octrt_bin;

constexpr int PREP_THREADS = 128;
constexpr int TILE_THREADS = 128;
constexpr int NWARP = TILE_THREADS / 32;
constexpr int GATHER_THREADS = 128;
constexpr int ROW4 = 4;  // float4s a 16-float table row

struct BinArgs {
  Prims s;
  const float* light_pos;  // (L, 3)
  int n_lights;
  const float *o0, *d0, *ddx, *ddy;  // the camera; o0 null: no camera
  int projective;
  float4* prims;   // (tp + sp, 2): box (x0, x1, y0, y1), then (z0, z1, 0, 0)
  float* planes;   // (L, tp, 16) triangle planes, or null: none binned
  int* t_idx;      // (n_tiles, w_tri)
  uint8_t* t_valid;
  int* s_idx;      // (n_tiles, w_sph)
  uint8_t* s_valid;
  float4* tri_attr_t;  // (n_tiles, w_tri, 8)
  float4* sph_attr_t;  // (n_tiles, w_sph, 8)
  float4* tri_sh_t;    // (n_tiles | 1, L * w_sh_tri, 16)
  float4* sph_sh_t;    // (n_tiles | 1, L * w_sh_sph, 16)
  int* counts;         // (n_tiles, 2 + 2L)
  uint8_t* overflow;   // ()
  int nty, ntx;
  int k_tri, k_sph, k_sh_tri, k_sh_sph;  // caps; 0: no list
  int w_tri, w_sph, w_sh_tri, w_sh_sph;  // the tables' widths (k, or a pad)
};

__device__ __forceinline__ void store_row(float4* dst, const float* row, int n4) {
  for (int k = 0; k < n4; ++k) {
    dst[k] = make_float4(row[4 * k], row[4 * k + 1], row[4 * k + 2], row[4 * k + 3]);
  }
}

template <class Args>  // BinArgs or SoftBinArgs
__device__ __forceinline__ V3 light(const Args& a, int li) {
  return load3(a.light_pos + 3 * li);
}

__global__ void __launch_bounds__(PREP_THREADS) bin_prep_kernel(BinArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Prims& s = a.s;
  const int L = a.n_lights;
  if (i == 0) *a.overflow = 0;
  Proj P;
  if (a.projective) P = make_proj(a.ddx, a.ddy, a.d0, a.o0);
  float row[16];
  if (i < s.tp) {
    const V3 v0 = s.v0(i), e1 = s.e1(i), e2 = s.e2(i);
    const V3 v1 = add(v0, e1), v2 = add(v0, e2);
    const Box b = a.projective ? tri_box_proj(P, v0, v1, v2) : tri_box_ortho(v0, v1, v2);
    a.prims[2 * i] = make_float4(b.x0, b.x1, b.y0, b.y1);
    a.prims[2 * i + 1] = make_float4(min3(v0.z, v1.z, v2.z) - Z_PAD,
                                     max3(v0.z, v1.z, v2.z) + Z_PAD, 0.0f, 0.0f);
    if (a.planes) {
      for (int li = 0; li < L; ++li) {
        tri_planes(v0, e1, e2, light(a, li), row);
        store_row(reinterpret_cast<float4*>(a.planes) + ((size_t)li * s.tp + i) * ROW4,
                  row, ROW4);
      }
    }
  } else if (i < s.tp + s.sp) {
    const int q = i - s.tp;
    const V3 c = s.centre(q);
    const float r = s.sph_radius[q];
    const Box b = a.projective ? sph_box_proj(P, c, r) : sph_box_ortho(c, r);
    const float rz = r + Z_PAD;
    a.prims[2 * i] = make_float4(b.x0, b.x1, b.y0, b.y1);
    a.prims[2 * i + 1] = make_float4(c.z - rz, c.z + rz, 0.0f, 0.0f);
    if (a.projective && a.k_sh_sph) {  // the shared table, padded spheres nulled
      if (q < s.n_sph) {
        sph_row(c, r, row);
      } else {
        null_sh_sph(row);
      }
      for (int li = 0; li < L; ++li) {
        store_row(a.sph_sh_t + ((size_t)li * s.sp + q) * ROW4, row, ROW4);
      }
    }
  }
  if (a.projective) {  // a shared table that lists nothing holds null rows
    if (!a.k_sh_tri && i < L * a.w_sh_tri) {
      null_sh_tri(row);
      store_row(a.tri_sh_t + (size_t)i * ROW4, row, ROW4);
    }
    if (!a.k_sh_sph && i < L * a.w_sh_sph) {
      null_sh_sph(row);
      store_row(a.sph_sh_t + (size_t)i * ROW4, row, ROW4);
    }
  }
}

// One warp's scan of primitives [0, n) in chunks of 32: hit(p) is lane p's
// test; emit(pos, p) takes the pos-th hit (ascending p) for pos < k. Returns
// the hits counted, exactly where at most k, else some count above k (the
// scan stops once it passes k). Warp-uniform n and k.
template <class Hit, class Emit>
__device__ __forceinline__ int scan(int n, int k, Hit hit, Emit emit) {
  const int lane = threadIdx.x & 31;
  int c = 0;
  for (int p0 = 0; p0 < n && c <= k; p0 += 32) {
    const int p = p0 + lane;
    const bool h = p < n && hit(p);
    const unsigned m = __ballot_sync(0xffffffffu, h);
    const int pos = c + __popc(m & ((1u << lane) - 1u));
    if (h && pos < k) emit(pos, p);
    c += __popc(m);
  }
  return c;
}

// idx[j] = 0 and valid[j] = 0 past the first m slots of a list of width w,
// valid[j] = 1 before them (the warp's scan wrote their indices).
__device__ __forceinline__ void close_list(int* idx, uint8_t* valid, int m, int w) {
  for (int j = threadIdx.x & 31; j < w; j += 32) {
    if (j >= m) idx[j] = 0;
    valid[j] = j < m;
  }
}

// Steps 1 and 2 of a tile's binning, the hard frame's and the soft frame's
// alike (Args: BinArgs or SoftBinArgs). The tile's rect (_bin_prims' tiles,
// offset by an ortho camera's origin); the primary lists, warp 0 the
// triangles and warp 1 the spheres: the first k primitives whose box
// overlaps the rect, in ascending order, zeros past the count, the count
// clamped to k into cnt[0] / cnt[1] and s_n (the caller's shared memory),
// the flag raised where a count passes k; then, where ortho shadow lists
// need it, the tile's hit-z slab over those lists (_tile_hit_z) as the
// rect's z0, z1. Every thread of the block calls it: two barriers.
template <class Args>
__device__ __forceinline__ Rect tile_primaries(const Args& a, int tile, int* cnt, int* s_n) {
  __shared__ float s_z[2];   // the tile's hit-z slab
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Prims& s = a.s;
  const int ty = tile / a.ntx, tx = tile - ty * a.ntx;
  const bool offs = a.o0 != nullptr && !a.projective;
  Rect t;
  t.x0 = (float)(tx * TILE_W) + (offs ? a.o0[0] : 0.0f);
  t.y0 = (float)(ty * TILE_H) + (offs ? a.o0[1] : 0.0f);
  t.x1 = t.x0 + (float)TILE_W;
  t.y1 = t.y0 + (float)TILE_H;

  // 1. the primary lists: warp 0 the triangles, warp 1 the spheres
  if (warp < 2) {
    const bool tri = warp == 0;
    const int k = tri ? a.k_tri : a.k_sph, w = tri ? a.w_tri : a.w_sph;
    const int n = tri ? s.n_tris : s.n_sph;
    const float4* box = a.prims + (tri ? 0 : 2 * s.tp);
    int* idx = (tri ? a.t_idx : a.s_idx) + (size_t)tile * w;
    const int c = scan(
        n, k,
        [&](int p) {
          const float4 b = box[2 * p];
          return box_overlap(t, Box{b.x, b.y, b.z, b.w});
        },
        [&](int pos, int p) { idx[pos] = p; });
    const int m = min(c, k);
    close_list(idx, (tri ? a.t_valid : a.s_valid) + (size_t)tile * w, m, w);
    if (lane == 0) {
      s_n[warp] = m;
      cnt[warp] = m;
      if (c > k) *a.overflow = 1;
    }
  }
  __syncthreads();

  // 2. the hit-z slab over the primary lists (the ortho shadow lists' input)
  const bool ortho_sh = !a.projective && (a.k_sh_tri || a.k_sh_sph);
  if (ortho_sh && warp == 0) {
    float z0 = SLAB_BIG, z1 = -SLAB_BIG;
    for (int j = lane; j < s_n[0]; j += 32) {
      const float4 z = a.prims[2 * a.t_idx[(size_t)tile * a.w_tri + j] + 1];
      z0 = fminf(z0, z.x);
      z1 = fmaxf(z1, z.y);
    }
    for (int j = lane; j < s_n[1]; j += 32) {
      const float4 z = a.prims[2 * (s.tp + a.s_idx[(size_t)tile * a.w_sph + j]) + 1];
      z0 = fminf(z0, z.x);
      z1 = fmaxf(z1, z.y);
    }
    for (int o = 16; o > 0; o >>= 1) {
      z0 = fminf(z0, __shfl_xor_sync(0xffffffffu, z0, o));
      z1 = fmaxf(z1, __shfl_xor_sync(0xffffffffu, z1, o));
    }
    if (lane == 0) {
      s_z[0] = z0;
      s_z[1] = z1;
    }
  }
  __syncthreads();
  if (ortho_sh) {
    t.z0 = s_z[0];
    t.z1 = s_z[1];
  }
  return t;
}

__global__ void __launch_bounds__(TILE_THREADS) bin_tiles_kernel(BinArgs a) {
  __shared__ int s_n[2];     // the primary lists' clamped counts
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = a.n_lights, stride = 2 + 2 * L;
  const Prims& s = a.s;
  int* cnt = a.counts + (size_t)tile * stride;
  const Rect t = tile_primaries(a, tile, cnt, s_n);

  // 3. the shadow lists: a warp a (light, kind); pinhole tiles share the
  // tables bin_prep_kernel wrote and count every primitive
  if (a.projective) {
    if ((int)threadIdx.x < L) {
      cnt[2 + 2 * threadIdx.x] = a.k_sh_tri ? s.n_tris : 0;
      cnt[3 + 2 * threadIdx.x] = a.k_sh_sph ? s.n_sph : 0;
    }
  } else {
    float row[16];
    for (int task = warp; task < 2 * L; task += NWARP) {
      const int li = task >> 1;
      const bool tri = (task & 1) == 0;
      const int k = tri ? a.k_sh_tri : a.k_sh_sph, w = tri ? a.w_sh_tri : a.w_sh_sph;
      float4* tab = (tri ? a.tri_sh_t : a.sph_sh_t) +
                    ((size_t)tile * L * w + (size_t)li * w) * ROW4;
      const V3 lp = light(a, li);
      const float4* prim = a.prims + (tri ? 0 : 2 * s.tp);
      const int c = k == 0 ? 0 : scan(
          tri ? s.n_tris : s.n_sph, k,
          [&](int p) {
            const float4 b = prim[2 * p], z = prim[2 * p + 1];
            return hull_overlap(t, lp, Box{b.x, b.y, b.z, b.w}, z.x, z.y);
          },
          [&](int pos, int p) {
            float4* dst = tab + (size_t)pos * ROW4;
            if (tri) {
              const float4* src = reinterpret_cast<const float4*>(a.planes) +
                                  ((size_t)li * s.tp + p) * ROW4;
              for (int q = 0; q < ROW4; ++q) dst[q] = src[q];
            } else {
              float r[16];
              sph_row(s.centre(p), s.sph_radius[p], r);
              store_row(dst, r, ROW4);
            }
          });
      const int m = min(c, k);
      if (tri) {
        null_sh_tri(row);
      } else {
        null_sh_sph(row);
      }
      for (int j = m + lane; j < w; j += 32) store_row(tab + (size_t)j * ROW4, row, ROW4);
      if (lane == 0) {
        cnt[2 + 2 * li + (tri ? 0 : 1)] = m;
        if (c > k) *a.overflow = 1;
      }
    }
  }

  // 4. the primary lists' attribute rows, zeros past each count
  for (int j = threadIdx.x; j < a.w_tri + a.w_sph; j += TILE_THREADS) {
    const bool tri = j < a.w_tri;
    const int jj = tri ? j : j - a.w_tri, w = tri ? a.w_tri : a.w_sph;
    float row[8];
    if (jj < s_n[tri ? 0 : 1]) {
      const int p = (tri ? a.t_idx : a.s_idx)[(size_t)tile * w + jj];
      if (tri) {
        tri_attr(s, p, row);
      } else {
        sph_attr(s, p, row);
      }
    } else {
      for (int q = 0; q < 8; ++q) row[q] = 0.0f;
    }
    store_row((tri ? a.tri_attr_t : a.sph_attr_t) + ((size_t)tile * w + jj) * 2, row, 2);
  }
}

struct GatherArgs {
  Prims s;
  const float *o0, *dox, *doy, *d0, *ddx, *ddy;  // the camera, (3,) each
  int projective;
  const float *light_pos, *light_colour, *light_intensity;  // (L, 3), (L, 3), (L,)
  const float *ambient, *spec, *shininess;                  // ()
  int n_lights;
  const int* t_idx;  // (n_tiles, w_tri)
  const uint8_t* t_valid;
  const int* s_idx;  // (n_tiles, w_sph)
  const uint8_t* s_valid;
  float* params;       // (21 + 7L,)
  float4* tri_coef_t;  // (n_tiles, w_tri, 16)
  float4* sph_coef_t;  // (n_tiles, w_sph, 16)
  int w_tri, w_sph;
};

__global__ void __launch_bounds__(GATHER_THREADS) gather_kernel(GatherArgs a) {
  const int tile = blockIdx.x;
  const Cam cam{load3(a.o0), load3(a.dox), load3(a.doy),
                load3(a.d0), load3(a.ddx), load3(a.ddy)};
  if (tile == 0) {  // _camera_params
    const int i = threadIdx.x;
    const float* parts[6] = {a.o0, a.dox, a.doy, a.d0, a.ddx, a.ddy};
    if (i < 18) {
      a.params[i] = parts[i / 3][i % 3];
    } else if (i < P_LIGHTS) {
      a.params[i] = *(i == 18 ? a.ambient : (i == 19 ? a.spec : a.shininess));
    } else if (i < P_LIGHTS + LIGHT_STRIDE * a.n_lights) {
      const int li = (i - P_LIGHTS) / LIGHT_STRIDE, k = (i - P_LIGHTS) % LIGHT_STRIDE;
      a.params[i] = k < 3 ? a.light_pos[3 * li + k]
                          : (k < 6 ? a.light_colour[3 * li + k - 3] : a.light_intensity[li]);
    }
  }
  float row[16];
  for (int j = threadIdx.x; j < a.w_tri + a.w_sph; j += GATHER_THREADS) {
    const bool tri = j < a.w_tri;
    const int jj = tri ? j : j - a.w_tri, w = tri ? a.w_tri : a.w_sph;
    const size_t at = (size_t)tile * w + jj;
    if (tri && a.t_valid[at]) {
      const int p = a.t_idx[at];
      if (a.projective) {
        tri_coef_proj(cam, a.s.v0(p), a.s.e1(p), a.s.e2(p), row);
      } else {
        tri_coef_affine(cam, a.s.v0(p), a.s.e1(p), a.s.e2(p), row);
      }
    } else if (!tri && a.s_valid[at]) {
      const int q = a.s_idx[at];
      if (a.projective) {
        sph_coef_proj(cam, a.s.centre(q), a.s.sph_radius[q], row);
      } else {
        sph_coef_affine(cam, a.s.centre(q), a.s.sph_radius[q], row);
      }
    } else {
      null_coef(tri, a.projective, row);
    }
    store_row((tri ? a.tri_coef_t : a.sph_coef_t) + at * ROW4, row, ROW4);
  }
}

// The soft frame's bins (soft_tiled.py SoftBins). Index lists are int32,
// valid masks one byte a slot (torch.bool).
struct SoftBinArgs {
  Prims s;
  const float* light_pos;  // (L, 3)
  int n_lights;
  const float *o0, *d0, *ddx, *ddy;  // the camera, (3,) each
  const float* tau_e;                // () tau_edge, read at every run
  int projective;
  float4* prims;   // (tp + sp, 2): box (x0, x1, y0, y1), then (z0, z1, 0, 0)
  int* t_idx;      // (n_tiles, w_tri)
  uint8_t* t_valid;
  int* s_idx;      // (n_tiles, w_sph)
  uint8_t* s_valid;
  int* tsh_idx;    // (L, n_tiles, w_sh_tri)
  uint8_t* tsh_valid;
  int* ssh_idx;    // (L, n_tiles, w_sh_sph)
  uint8_t* ssh_valid;
  int* counts;     // (n_tiles, 2 + 2L)
  uint8_t* overflow;  // ()
  int nty, ntx;
  int k_tri, k_sph, k_sh_tri, k_sh_sph;  // caps; 0: no list
  int w_tri, w_sph, w_sh_tri, w_sh_sph;  // the lists' widths (k, or CH)
};

__global__ void __launch_bounds__(PREP_THREADS) bin_soft_prep_kernel(SoftBinArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Prims& s = a.s;
  if (i == 0) *a.overflow = 0;
  const float pad = SOFT_CULL_SIGMAS * *a.tau_e;
  const float z_pad = pad + SHADOW_OFFSET;
  Proj P;
  if (a.projective) P = make_proj(a.ddx, a.ddy, a.d0, a.o0);
  if (i < s.tp) {
    const V3 v0 = s.v0(i), v1 = add(v0, s.e1(i)), v2 = add(v0, s.e2(i));
    const Box b = a.projective
                      ? aabb_box_proj(P, {min3(v0.x, v1.x, v2.x), min3(v0.y, v1.y, v2.y),
                                          min3(v0.z, v1.z, v2.z)},
                                      {max3(v0.x, v1.x, v2.x), max3(v0.y, v1.y, v2.y),
                                       max3(v0.z, v1.z, v2.z)},
                                      pad)
                      : pad_box(tri_box_ortho(v0, v1, v2), pad);
    a.prims[2 * i] = make_float4(b.x0, b.x1, b.y0, b.y1);
    a.prims[2 * i + 1] = make_float4(min3(v0.z, v1.z, v2.z) - z_pad,
                                     max3(v0.z, v1.z, v2.z) + z_pad, 0.0f, 0.0f);
  } else if (i < s.tp + s.sp) {
    const int q = i - s.tp;
    const V3 c = s.centre(q);
    const float r = s.sph_radius[q];
    const Box b = a.projective
                      ? aabb_box_proj(P, {c.x - r, c.y - r, c.z - r}, {c.x + r, c.y + r, c.z + r},
                                      pad)
                      : pad_box(sph_box_ortho(c, r), pad);
    const float rz = r + z_pad;
    a.prims[2 * i] = make_float4(b.x0, b.x1, b.y0, b.y1);
    a.prims[2 * i + 1] = make_float4(c.z - rz, c.z + rz, 0.0f, 0.0f);
  }
}

__global__ void __launch_bounds__(TILE_THREADS) bin_soft_tiles_kernel(SoftBinArgs a) {
  __shared__ int s_n[2];     // the primary lists' clamped counts
  const int tile = blockIdx.x, n_tiles = a.nty * a.ntx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = a.n_lights;
  const Prims& s = a.s;
  int* cnt = a.counts + (size_t)tile * (2 + 2 * L);
  const Rect t = tile_primaries(a, tile, cnt, s_n);

  // 3. the shadow lists, a warp a (light, kind): ortho lists by the
  // segment-hull test; a pinhole list is empty and counts every primitive
  for (int task = warp; task < 2 * L; task += NWARP) {
    const int li = task >> 1;
    const bool tri = (task & 1) == 0;
    const int k = tri ? a.k_sh_tri : a.k_sh_sph, w = tri ? a.w_sh_tri : a.w_sh_sph;
    const int n = tri ? s.n_tris : s.n_sph;
    const size_t at = ((size_t)li * n_tiles + tile) * w;
    int* idx = (tri ? a.tsh_idx : a.ssh_idx) + at;
    const V3 lp = light(a, li);
    const float4* prim = a.prims + (tri ? 0 : 2 * s.tp);
    const bool binned = k && !a.projective;
    const int c = !binned ? 0 : scan(
        n, k,
        [&](int p) {
          const float4 b = prim[2 * p], z = prim[2 * p + 1];
          return hull_overlap(t, lp, Box{b.x, b.y, b.z, b.w}, z.x, z.y);
        },
        [&](int pos, int p) { idx[pos] = p; });
    const int m = min(c, k);
    close_list(idx, (tri ? a.tsh_valid : a.ssh_valid) + at, m, w);
    if (lane == 0) {
      cnt[2 + 2 * li + (tri ? 0 : 1)] = binned ? m : (k ? n : 0);
      if (c > k) *a.overflow = 1;
    }
  }
}

Prims make_prims(const float* tri_v0, const float* tri_e1, const float* tri_e2,
                 const float* tri_colour, const float* sph_origin,
                 const float* sph_radius, const float* sph_colour, int tp,
                 int sp, int n_tris, int n_sph) {
  return Prims{tri_v0, tri_e1, tri_e2, tri_colour, sph_origin, sph_radius,
               sph_colour, tp, sp, n_tris, n_sph};
}

}  // namespace

// The tables of fwd_tiled.py's TileBins for one frame, in two launches on
// `stream`: the per-primitive pass, then one block a tile. prims and planes
// are the wrapper's scratch (planes: the ortho shadow lists' source, or the
// pinhole tri_sh_t itself; null where no triangle table is binned). o0 is
// null for a frame binned without a camera; d0, ddx, ddy are read only for a
// pinhole camera.
extern "C" int octrt_bin_tiled(
    const float* tri_v0, const float* tri_e1, const float* tri_e2,
    const float* tri_colour, const float* sph_origin, const float* sph_radius,
    const float* sph_colour, const float* light_pos, const float* o0,
    const float* d0, const float* ddx, const float* ddy, float* prims,
    float* planes, int* t_idx, uint8_t* t_valid, int* s_idx, uint8_t* s_valid,
    float* tri_attr_t, float* sph_attr_t, float* tri_sh_t, float* sph_sh_t,
    int* counts, uint8_t* overflow, int tp, int sp, int n_tris, int n_sph,
    int n_lights, int nty, int ntx, int projective, int k_tri, int k_sph,
    int k_sh_tri, int k_sh_sph, int w_tri, int w_sph, int w_sh_tri,
    int w_sh_sph, void* stream) {
  if (n_lights < 1 || nty < 1 || ntx < 1 || tp < 1 || sp < 1 ||
      (projective && (!o0 || !d0 || !ddx || !ddy))) {
    return (int)cudaErrorInvalidValue;
  }
  const auto f4 = [](float* p) { return reinterpret_cast<float4*>(p); };
  BinArgs a{};
  a.s = make_prims(tri_v0, tri_e1, tri_e2, tri_colour, sph_origin, sph_radius,
              sph_colour, tp, sp, n_tris, n_sph);
  a.light_pos = light_pos;
  a.n_lights = n_lights;
  a.o0 = o0;
  a.d0 = d0;
  a.ddx = ddx;
  a.ddy = ddy;
  a.projective = projective;
  a.prims = f4(prims);
  a.planes = planes;
  a.t_idx = t_idx;
  a.t_valid = t_valid;
  a.s_idx = s_idx;
  a.s_valid = s_valid;
  a.tri_attr_t = f4(tri_attr_t);
  a.sph_attr_t = f4(sph_attr_t);
  a.tri_sh_t = f4(tri_sh_t);
  a.sph_sh_t = f4(sph_sh_t);
  a.counts = counts;
  a.overflow = overflow;
  a.nty = nty;
  a.ntx = ntx;
  a.k_tri = k_tri;
  a.k_sph = k_sph;
  a.k_sh_tri = k_sh_tri;
  a.k_sh_sph = k_sh_sph;
  a.w_tri = w_tri;
  a.w_sph = w_sph;
  a.w_sh_tri = w_sh_tri;
  a.w_sh_sph = w_sh_sph;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int n_prep = std::max(tp + sp, n_lights * std::max(w_sh_tri, w_sh_sph));
  bin_prep_kernel<<<(n_prep + PREP_THREADS - 1) / PREP_THREADS, PREP_THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bin_tiles_kernel<<<nty * ntx, TILE_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// B1's params and coefficient tables for one frame from its bins, in one
// launch on `stream`. The camera's six vectors and the lights' arrays are
// float32 on the card.
extern "C" int octrt_gather_tiled(
    const float* tri_v0, const float* tri_e1, const float* tri_e2,
    const float* sph_origin, const float* sph_radius, const float* o0,
    const float* dox, const float* doy, const float* d0, const float* ddx,
    const float* ddy, const float* light_pos, const float* light_colour,
    const float* light_intensity, const float* ambient, const float* spec,
    const float* shininess, const int* t_idx, const uint8_t* t_valid,
    const int* s_idx, const uint8_t* s_valid, float* params, float* tri_coef_t,
    float* sph_coef_t, int tp, int sp, int n_lights, int n_tiles, int w_tri,
    int w_sph, int projective, void* stream) {
  if (n_lights < 1 || n_tiles < 1 ||
      P_LIGHTS + LIGHT_STRIDE * n_lights > GATHER_THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  GatherArgs a{};
  a.s = make_prims(tri_v0, tri_e1, tri_e2, nullptr, sph_origin, sph_radius, nullptr,
              tp, sp, 0, 0);
  a.o0 = o0;
  a.dox = dox;
  a.doy = doy;
  a.d0 = d0;
  a.ddx = ddx;
  a.ddy = ddy;
  a.projective = projective;
  a.light_pos = light_pos;
  a.light_colour = light_colour;
  a.light_intensity = light_intensity;
  a.ambient = ambient;
  a.spec = spec;
  a.shininess = shininess;
  a.n_lights = n_lights;
  a.t_idx = t_idx;
  a.t_valid = t_valid;
  a.s_idx = s_idx;
  a.s_valid = s_valid;
  a.params = params;
  a.tri_coef_t = reinterpret_cast<float4*>(tri_coef_t);
  a.sph_coef_t = reinterpret_cast<float4*>(sph_coef_t);
  a.w_tri = w_tri;
  a.w_sph = w_sph;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  gather_kernel<<<n_tiles, GATHER_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// The lists of soft_tiled.py's SoftBins for one frame, in two launches on
// `stream`: the per-primitive pass, then one block a tile. prims is the
// wrapper's scratch, (tp + sp, 8) floats. tau_e is a float on the card, read
// at each run (a captured graph follows it). d0, ddx, ddy are read only for
// a pinhole camera, o0 for both.
extern "C" int octrt_bin_soft(
    const float* tri_v0, const float* tri_e1, const float* tri_e2,
    const float* sph_origin, const float* sph_radius, const float* light_pos,
    const float* o0, const float* d0, const float* ddx, const float* ddy,
    const float* tau_e, float* prims, int* t_idx, uint8_t* t_valid, int* s_idx,
    uint8_t* s_valid, int* tsh_idx, uint8_t* tsh_valid, int* ssh_idx,
    uint8_t* ssh_valid, int* counts, uint8_t* overflow, int tp, int sp,
    int n_tris, int n_sph, int n_lights, int nty, int ntx, int projective,
    int k_tri, int k_sph, int k_sh_tri, int k_sh_sph, int w_tri, int w_sph,
    int w_sh_tri, int w_sh_sph, void* stream) {
  if (n_lights < 1 || nty < 1 || ntx < 1 || tp < 1 || sp < 1 || !o0 || !tau_e ||
      (projective && (!d0 || !ddx || !ddy))) {
    return (int)cudaErrorInvalidValue;
  }
  SoftBinArgs a{};
  a.s = make_prims(tri_v0, tri_e1, tri_e2, nullptr, sph_origin, sph_radius, nullptr,
                   tp, sp, n_tris, n_sph);
  a.light_pos = light_pos;
  a.n_lights = n_lights;
  a.o0 = o0;
  a.d0 = d0;
  a.ddx = ddx;
  a.ddy = ddy;
  a.tau_e = tau_e;
  a.projective = projective;
  a.prims = reinterpret_cast<float4*>(prims);
  a.t_idx = t_idx;
  a.t_valid = t_valid;
  a.s_idx = s_idx;
  a.s_valid = s_valid;
  a.tsh_idx = tsh_idx;
  a.tsh_valid = tsh_valid;
  a.ssh_idx = ssh_idx;
  a.ssh_valid = ssh_valid;
  a.counts = counts;
  a.overflow = overflow;
  a.nty = nty;
  a.ntx = ntx;
  a.k_tri = k_tri;
  a.k_sph = k_sph;
  a.k_sh_tri = k_sh_tri;
  a.k_sh_sph = k_sh_sph;
  a.w_tri = w_tri;
  a.w_sph = w_sph;
  a.w_sh_tri = w_sh_tri;
  a.w_sh_sph = w_sh_sph;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  bin_soft_prep_kernel<<<(tp + sp + PREP_THREADS - 1) / PREP_THREADS, PREP_THREADS, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bin_soft_tiles_kernel<<<nty * ntx, TILE_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
