// Brute hard forward frame for Hopper (sm_90a): every pixel against every
// primitive, four pixels a thread.
//
// Replaces the TPU kernel opencl_ray_tracer_tpu/kernels/fwd.py:_build_kernel
// (launched by _render_pallas_jit). The plain PyTorch twin is
// opencl_ray_tracer_tpu_torch/kernels/fwd.py:_brute_kernel_plain; the two
// agree operation for operation.
//
// What it computes, per pixel:
//   - the ray from the camera params (affine ray bundle; pinhole directions
//     are normalised);
//   - the nearest hit over all triangles, then all spheres, in ascending
//     index with strict `<` (the first minimal index wins; triangles win
//     ties against spheres; init MISS_T). Shared-direction cameras use the
//     per-primitive affine (triangle) and quadratic (sphere) coefficients in
//     pixel coordinates, pinhole cameras Moller-Trumbore and the geometric
//     sphere test (tca < 0 misses, an exact-0 distance is discarded);
//   - legacy depth fog, or lambert/phong with any-hit hard shadows: shadow
//     rays have per-pixel directions, so they always take the general tests;
//   - float RGBA (r, g, b, 255), written where the pixel is inside the frame.
//
// It stops at the real primitive counts: a padded triangle is degenerate
// (never valid) and a padded sphere lies at z = 1e9, beyond MISS_T and any
// light, so neither can win a hit or block a shadow ray. No primitive is
// culled for any pixel: it is the unculled cross-check of the tiled kernel.
//
// What bounds it on this card: FP32 ALU work, pixels x primitives x (about
// 12 operations per affine test, 45 per general triangle test, 20 per
// general sphere test), against 16 B of output per pixel and a scene of a
// few KB; and -fmad=false (each product and sum rounds once, as the twin's)
// makes every multiply-add two operations. So the design spends as little
// as it can beside the arithmetic:
//   - primitives are staged through shared memory primitive-major, one
//     primitive's 9 or 10 coefficients in three float4s (a sphere's centre
//     and radius in one), so a test costs three 128-bit broadcast loads in
//     place of nine or ten 32-bit ones;
//   - a thread holds four pixels of one row (x, x + 32, x + 64, x + 96: a
//     warp covers 128 consecutive pixels and each of its stores is one
//     512-byte run), so every loaded coefficient feeds four tests, and the
//     products with y, which the four share, are taken once (each is the
//     same product the twin takes per pixel, so no bit moves); a frame too
//     small to give every multiprocessor four such blocks runs one pixel a
//     thread instead;
//   - a sphere's root is taken only where the discriminant test passed (t
//     is read nowhere else), and a pixel that hit nothing is written as
//     (0, 0, 0, 255) without its ray, shading or lights: 99% of the
//     headline frame;
//   - where the whole scene's geometry fits in shared memory (48 B a
//     triangle, 16 B a sphere: ~4,000 triangles) a block stages it once,
//     and only if one of its pixels hit something; then every lit pixel
//     walks to its first occluder on its own, four primitives at a time
//     (their divides overlap), for every light, with no barrier. A larger scene walks 128 primitives at a time behind block
//     barriers, and leaves a loop once all its pixels are done;
//   - the inner loop carries only (t, index) per pixel, and the winner's
//     attributes are read once per lit pixel by index (the TPU kernel's
//     one-hot matrix product).
//
// Numerics: built without --use_fast_math and with -fmad=false, so every
// product and sum rounds once, in the twin's order (ties hang on the last
// bit of t); 1/sqrtf where the twin has 1/torch.sqrt.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int PX_MAX = 4;       // pixels a thread: x + 32 k of one row
constexpr int CK = 128;         // primitives per stage of the nearest-hit loop
// Blocks a multiprocessor that the compiler must leave registers for.
constexpr int BLOCKS = 4;
// The most dynamic shared memory the whole-scene shadow walk may ask for.
constexpr int GEO_BYTES_MAX = 200 * 1024;

constexpr float MISS_T = 300000.0f;
constexpr float EPSILON = 1e-6f;
constexpr float FOG_K = (float)(255.0 / 180.0);

// params layout (kernels/fwd.py _P_*)
constexpr int P_O0 = 0, P_DOX = 3, P_DOY = 6, P_D0 = 9, P_DDX = 12, P_DDY = 15;
constexpr int P_AMBIENT = 18, P_SPEC = 19, P_SHINE = 20;
constexpr int P_LIGHTS = 21, LIGHT_STRIDE = 7;

enum { SHADE_LEGACY = 0, SHADE_LAMBERT = 1, SHADE_PHONG = 2 };

struct Args {
  const float* params;
  const float* tri_geo;   // (9, tp)  v0, e1, e2
  const float* tri_attr;  // (tp, 8)  r, g, b, unit normal, 0, 0
  const float* sph_geo;   // (4, sp)  centre, radius
  const float* sph_attr;  // (sp, 8)  r, g, b, centre, 1/radius, 1
  const float* tri_coef;  // (9, tp)  affine u, v, t (shared-direction only)
  const float* sph_coef;  // (10, sp) affine tca, quadratic d2, r2
  float4* out;            // (height, width) float RGBA
  int height, width, tp, sp, n_tris, n_spheres, n_lights, shadows;
  const int* run_if;  // null: always run; else run only if *run_if == want
  int want;           // (lax.cond on the card: the untaken branch returns)
};

// Columns [base, base + n) of a row-major (rows, stride) operand into
// primitive-major shared memory: primitive j's rows in dst[j * W4 ...], W4
// float4s a primitive (the floats past `rows` are never read).
template <int W4>
__device__ __forceinline__ void stage(float4* dst, const float* src, int rows,
                                      int stride, int base, int n) {
  float* d = reinterpret_cast<float*>(dst);
  for (int i = threadIdx.x; i < rows * n; i += THREADS) {
    const int q = i / n, j = i - q * n;
    d[j * (4 * W4) + q] = __ldg(src + (size_t)q * stride + base + j);
  }
}

__device__ __forceinline__ float prm(const Args& a, int i) {
  return __ldg(a.params + i);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray make_ray(const Args& a, float x, float y,
                                        bool normalise) {
  Ray r;
  r.ox = prm(a, P_O0) + x * prm(a, P_DOX) + y * prm(a, P_DOY);
  r.oy = prm(a, P_O0 + 1) + x * prm(a, P_DOX + 1) + y * prm(a, P_DOY + 1);
  r.oz = prm(a, P_O0 + 2) + x * prm(a, P_DOX + 2) + y * prm(a, P_DOY + 2);
  r.dx = prm(a, P_D0) + x * prm(a, P_DDX) + y * prm(a, P_DDY);
  r.dy = prm(a, P_D0 + 1) + x * prm(a, P_DDX + 1) + y * prm(a, P_DDY + 1);
  r.dz = prm(a, P_D0 + 2) + x * prm(a, P_DDX + 2) + y * prm(a, P_DDY + 2);
  if (normalise) {  // pinhole: per-pixel directions
    const float inv = 1.0f / sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
    r.dx = r.dx * inv;
    r.dy = r.dy * inv;
    r.dz = r.dz * inv;
  }
  return r;
}

// --- general tests (fwd.py _tri_chunk_t / _sph_chunk_t), term by term ----
// s: v0 (x, y, z), e1 (w | x, y), e2 (z, w | x); the rest is padding.
__device__ __forceinline__ bool tri_general(const float4* s, const Ray& r,
                                            float& t) {
  const float4 A = s[0], B = s[1], C = s[2];
  const float v0x = A.x, v0y = A.y, v0z = A.z;
  const float e1x = A.w, e1y = B.x, e1z = B.y;
  const float e2x = B.z, e2y = B.w, e2z = C.x;
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool det_ok = fabsf(det) >= EPSILON;
  const float inv_det = 1.0f / (det_ok ? det : 1.0f);
  const float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  return det_ok & (u >= 0.0f) & (u <= 1.0f) & (v >= 0.0f) & (u + v <= 1.0f);
}

// g: centre, radius. The root is taken only where the sphere is hit: t is
// read nowhere else.
__device__ __forceinline__ bool sph_general(const float4 g, const Ray& r,
                                            float& t) {
  const float lx = g.x - r.ox, ly = g.y - r.oy, lz = g.z - r.oz;
  const float tca = lx * r.dx + ly * r.dy + lz * r.dz;
  const float m2 = lx * lx + ly * ly + lz * lz - tca * tca;
  const float r2 = g.w * g.w;
  if (!((tca >= 0.0f) & (m2 <= r2))) return false;
  t = tca - sqrtf(fmaxf(r2 - m2, 0.0f));
  return t != 0.0f;
}

__device__ __forceinline__ bool occludes(bool valid, float t, float t_max) {
  return valid & (t > 1e-3f) & (t < t_max);
}

// Shadow any-hit with the whole scene's geometry in shared memory (n_tris
// triangles of three float4s, then n_spheres of one): anything in (1e-3,
// t_max) along the ray? A thread walks alone, to its first occluder, WALK
// primitives at a time: their tests do not depend on each other, so their
// divides and roots overlap, and the walk leaves after the group that held
// an occluder.
constexpr int WALK = 4;

__device__ bool any_occluder_whole(const float4* geo, int n_tris, int n_spheres,
                                   const Ray& r, float t_max) {
  int j = 0;
  for (; j + WALK <= n_tris; j += WALK) {
    bool occ = false;
#pragma unroll
    for (int q = 0; q < WALK; ++q) {
      float t;
      const bool valid = tri_general(geo + 3 * (j + q), r, t);
      occ |= occludes(valid, t, t_max);
    }
    if (occ) return true;
  }
  for (; j < n_tris; ++j) {
    float t;
    if (occludes(tri_general(geo + 3 * j, r, t), t, t_max)) return true;
  }
  const float4* sph = geo + 3 * n_tris;
  for (j = 0; j + WALK <= n_spheres; j += WALK) {
    bool occ = false;
#pragma unroll
    for (int q = 0; q < WALK; ++q) {
      float t = 0.0f;
      const bool valid = sph_general(sph[j + q], r, t);
      occ |= occludes(valid, t, t_max);
    }
    if (occ) return true;
  }
  for (; j < n_spheres; ++j) {
    float t = 0.0f;
    if (occludes(sph_general(sph[j], r, t), t, t_max)) return true;
  }
  return false;
}

// The same over n primitives of one kind, staged CK at a time by the whole
// block. `done` threads skip the tests; the block leaves the loop once all
// its threads are done. Every thread of the block must call it.
template <bool SPHERE>
__device__ bool any_occluder_staged(float4* smem, const float* geo, int stride,
                                    int n, const Ray& r, float t_max,
                                    bool done) {
  bool occ = false;
  for (int base = 0; base < n; base += CK) {
    if (__syncthreads_and(done)) break;  // also guards the stage's reuse
    const int m = min(CK, n - base);
    if (SPHERE) stage<1>(smem, geo, 4, stride, base, m);
    else stage<3>(smem, geo, 9, stride, base, m);
    __syncthreads();
    if (!done) {
      for (int j = 0; j < m; ++j) {
        float t = 0.0f;
        const bool valid = SPHERE ? sph_general(smem[j], r, t)
                                  : tri_general(smem + 3 * j, r, t);
        if (occludes(valid, t, t_max)) {
          occ = true;
          done = true;
          break;
        }
      }
    }
  }
  return occ;
}

// The colour of one pixel from its nearest hit (t, code: the triangle's
// index, or ~index for a sphere). WHOLE: the scene's geometry is in s_geo
// (or there are no shadows) and a pixel that is not `lit` returns at once;
// otherwise every thread of the block must call, and walks the staged
// shadow loops with the others.
template <bool AFFINE, int SHADING, bool WHOLE>
__device__ float4 shade(const Args& a, float x, float y, float t, int code,
                        bool lit, const float4* s_geo, float4* s_stage) {
  const float4 bg = make_float4(0.0f, 0.0f, 0.0f, 255.0f);
  if ((WHOLE || SHADING == SHADE_LEGACY) && !lit) return bg;
  // winner attributes, one indexed read per lit pixel:
  // [r, g, b, nx|cx, ny|cy, nz|cz, 1/rad, is_sphere]
  float at[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (lit) {
    const float* ap = code < 0 ? a.sph_attr + (size_t)(~code) * 8
                               : a.tri_attr + (size_t)code * 8;
    const float4 lo = __ldg(reinterpret_cast<const float4*>(ap));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(ap) + 1);
    at[0] = lo.x; at[1] = lo.y; at[2] = lo.z; at[3] = lo.w;
    at[4] = hi.x; at[5] = hi.y; at[6] = hi.z; at[7] = hi.w;
  }
  if (SHADING == SHADE_LEGACY) {
    const float s = 255.0f - t * FOG_K;
    return make_float4(at[0] * s, at[1] * s, at[2] * s, 255.0f);
  }
  const Ray ray = make_ray(a, x, y, !AFFINE);
  const float px = ray.ox + t * ray.dx;
  const float py = ray.oy + t * ray.dy;
  const float pz = ray.oz + t * ray.dz;
  const float ax = at[3], ay = at[4], az = at[5];
  const float nsx = (px - ax) * at[6];
  const float nsy = (py - ay) * at[6];
  const float nsz = (pz - az) * at[6];
  const float flip =
      (ax * ray.dx + ay * ray.dy + az * ray.dz > 0.0f) ? -1.0f : 1.0f;
  const bool is_sph = at[7] > 0.5f;
  float nx = is_sph ? nsx : ax * flip;
  float ny = is_sph ? nsy : ay * flip;
  float nz = is_sph ? nsz : az * flip;
  const float ninv = 1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-20f));
  nx = nx * ninv;
  ny = ny * ninv;
  nz = nz * ninv;
  const float vinv = 1.0f / sqrtf(fmaxf(
      ray.dx * ray.dx + ray.dy * ray.dy + ray.dz * ray.dz, 1e-20f));
  const float vx = -ray.dx * vinv, vy = -ray.dy * vinv, vz = -ray.dz * vinv;

  const float ambient = prm(a, P_AMBIENT);
  const float spec_k = prm(a, P_SPEC);
  const float shine = prm(a, P_SHINE);
  float diff_r = 0.f, diff_g = 0.f, diff_b = 0.f;
  float spec_r = 0.f, spec_g = 0.f, spec_b = 0.f;
  for (int li = 0; li < a.n_lights; ++li) {
    const int base = P_LIGHTS + li * LIGHT_STRIDE;
    const float tlx = prm(a, base) - px;
    const float tly = prm(a, base + 1) - py;
    const float tlz = prm(a, base + 2) - pz;
    const float lcr = prm(a, base + 3), lcg = prm(a, base + 4);
    const float lcb = prm(a, base + 5), lint = prm(a, base + 6);
    const float dist = sqrtf(fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-20f));
    const float ldx = tlx / dist, ldy = tly / dist, ldz = tlz / dist;
    const float ndl = nx * ldx + ny * ldy + nz * ldz;
    const float ndotl = fmaxf(ndl, 0.0f);

    float vis = 1.0f;
    if (a.shadows) {  // block-uniform
      const Ray sr{px + 1e-2f * nx, py + 1e-2f * ny, pz + 1e-2f * nz,
                   ldx, ldy, ldz};
      bool occ;
      if (WHOLE) {
        occ = any_occluder_whole(s_geo, a.n_tris, a.n_spheres, sr, dist);
      } else {
        occ = any_occluder_staged<false>(s_stage, a.tri_geo, a.tp, a.n_tris,
                                         sr, dist, !lit);
        occ |= any_occluder_staged<true>(s_stage, a.sph_geo, a.sp, a.n_spheres,
                                         sr, dist, !lit || occ);
      }
      vis = occ ? 0.0f : 1.0f;
    }
    const float wdiff = lint * ndotl * vis;
    diff_r += wdiff * lcr;
    diff_g += wdiff * lcg;
    diff_b += wdiff * lcb;
    if (SHADING == SHADE_PHONG) {
      const float two_ndl = 2.0f * ndl;
      const float rx = two_ndl * nx - ldx;
      const float ry = two_ndl * ny - ldy;
      const float rz = two_ndl * nz - ldz;
      const float rdotv = fmaxf(rx * vx + ry * vy + rz * vz, 0.0f);
      const float wspec = spec_k * expf(shine * logf(fmaxf(rdotv, 1e-20f))) *
                          lint * vis * (ndotl > 0.0f ? 1.0f : 0.0f);
      spec_r += wspec * lcr;
      spec_g += wspec * lcg;
      spec_b += wspec * lcb;
    }
  }
  if (!lit) return bg;
  return make_float4(
      fminf(fmaxf(at[0] * (ambient + diff_r) + spec_r, 0.0f), 1.0f) * 255.0f,
      fminf(fmaxf(at[1] * (ambient + diff_g) + spec_g, 0.0f), 1.0f) * 255.0f,
      fminf(fmaxf(at[2] * (ambient + diff_b) + spec_b, 0.0f), 1.0f) * 255.0f,
      255.0f);
}

// PX: the pixels a thread holds; a warp covers 32 PX consecutive pixels.
template <bool AFFINE, int SHADING, bool WHOLE, int PX>
__global__ void __launch_bounds__(THREADS, BLOCKS) fwd_brute_kernel(Args a) {
  if (a.run_if != nullptr && __ldg(a.run_if) != a.want) return;  // see Args::run_if
  constexpr int SPAN = 32 * PX;
  __shared__ float4 s_stage[CK * 3];
  extern __shared__ float4 s_geo[];  // WHOLE with shadows: the scene's geometry

  // a warp: SPAN consecutive pixels of one row; lane l holds x0 + 32 k, k < PX
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int spans = (a.width + SPAN - 1) / SPAN;
  const int wid = blockIdx.x * NWARP + warp;
  const int row = wid / spans;
  const int x0 = (wid - row * spans) * SPAN + lane;
  const int yi = min(row, a.height - 1);  // a valid pixel for the spares
  const float y = (float)yi;
  int xi[PX];
  float x[PX];
  bool inside[PX];
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    inside[k] = row < a.height && x0 + 32 * k < a.width;
    xi[k] = min(x0 + 32 * k, a.width - 1);
    x[k] = (float)xi[k];
  }
  const float y2 = y * y;
  Ray ray[PX];
  if (!AFFINE) {
#pragma unroll
    for (int k = 0; k < PX; ++k) ray[k] = make_ray(a, x[k], y, true);
  }

  // ---- nearest hit: triangles, then spheres (strict <) -----------------
  float best_t[PX];
  int best[PX];  // the triangle's index, or ~index of a sphere
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    best_t[k] = MISS_T;
    best[k] = 0;
  }
  for (int base = 0; base < a.n_tris; base += CK) {
    const int m = min(CK, a.n_tris - base);
    __syncthreads();
    stage<3>(s_stage, AFFINE ? a.tri_coef : a.tri_geo, 9, a.tp, base, m);
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      if (AFFINE) {  // fwd.py _tri_chunk_t_affine: u, v, t affine in (x, y)
        const float4 A = s_stage[3 * j], B = s_stage[3 * j + 1];
        const float4 C = s_stage[3 * j + 2];
        const float yu = y * A.z, yv = y * B.y, yt = y * C.x;
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          const float u = A.x + x[k] * A.y + yu;
          const float v = A.w + x[k] * B.x + yv;
          const float t = B.z + x[k] * B.w + yt;
          const bool valid =
              (u >= 0.0f) & (u <= 1.0f) & (v >= 0.0f) & (u + v <= 1.0f);
          if (valid && t < best_t[k]) {
            best_t[k] = t;
            best[k] = base + j;
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          float t;
          if (tri_general(s_stage + 3 * j, ray[k], t) && t < best_t[k]) {
            best_t[k] = t;
            best[k] = base + j;
          }
        }
      }
    }
  }
  for (int base = 0; base < a.n_spheres; base += CK) {
    const int m = min(CK, a.n_spheres - base);
    __syncthreads();
    if (AFFINE) stage<3>(s_stage, a.sph_coef, 10, a.sp, base, m);
    else stage<1>(s_stage, a.sph_geo, 4, a.sp, base, m);
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      if (AFFINE) {  // fwd.py _sph_chunk_t_affine: tca affine, d2 quadratic
        const float4 A = s_stage[3 * j], B = s_stage[3 * j + 1];
        const float4 C = s_stage[3 * j + 2];
        const float yc = y * A.z, yd = y * B.y, y2d = y2 * B.w;
        const float r2 = C.y;
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          const float tca = A.x + x[k] * A.y + yc;
          const float d2 = A.w + x[k] * B.x + yd + (x[k] * x[k]) * B.z + y2d +
                           (x[k] * y) * C.x;
          if ((tca >= 0.0f) & (d2 <= r2)) {  // the root only on a hit
            const float t = tca - sqrtf(fmaxf(r2 - d2, 0.0f));
            if (t != 0.0f && t < best_t[k]) {
              best_t[k] = t;
              best[k] = ~(base + j);
            }
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          float t = 0.0f;
          if (sph_general(s_stage[j], ray[k], t) && t < best_t[k]) {
            best_t[k] = t;
            best[k] = ~(base + j);
          }
        }
      }
    }
  }

  bool lit[PX];
  bool any_lit = false;
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    lit[k] = inside[k] && best_t[k] < MISS_T;
    any_lit |= lit[k];
  }
  if (WHOLE && SHADING != SHADE_LEGACY && a.shadows) {
    // the scene's geometry, once, and only for a block that shades a pixel
    if (__syncthreads_or(any_lit)) {
      stage<3>(s_geo, a.tri_geo, 9, a.tp, 0, a.n_tris);
      stage<1>(s_geo + 3 * a.n_tris, a.sph_geo, 4, a.sp, 0, a.n_spheres);
      __syncthreads();
    }
  }
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const float4 rgba = shade<AFFINE, SHADING, WHOLE>(
        a, x[k], y, best_t[k], best[k], lit[k], s_geo, s_stage);
    if (inside[k]) a.out[(size_t)yi * a.width + xi[k]] = rgba;
  }
}

inline int blocks_for(const Args& a, int px) {
  const int spans = (a.width + 32 * px - 1) / (32 * px);
  return (spans * a.height + NWARP - 1) / NWARP;
}

template <bool AFFINE, int SHADING, bool WHOLE, int PX>
cudaError_t launch4(const Args& a, size_t geo_bytes, cudaStream_t stream) {
  auto kernel = fwd_brute_kernel<AFFINE, SHADING, WHOLE, PX>;
  if (geo_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks_for(a, PX), THREADS, geo_bytes, stream>>>(a);
  return cudaGetLastError();
}

// Four pixels a thread where that still leaves every multiprocessor four
// blocks (a 1080p frame has 2,025); on a smaller frame one pixel a thread:
// few long blocks fill the card unevenly, and the shadow walks, whose
// divides wait on each other, want more warps to hide behind (640x480 with
// 1,300 primitives: 1.68 ms at four pixels, 1.36 at one).
template <bool AFFINE, int SHADING, bool WHOLE>
cudaError_t launch3(const Args& a, size_t geo_bytes, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (blocks_for(a, PX_MAX) >= 4 * sms) {
    return launch4<AFFINE, SHADING, WHOLE, PX_MAX>(a, geo_bytes, stream);
  }
  return launch4<AFFINE, SHADING, WHOLE, 1>(a, geo_bytes, stream);
}

template <bool AFFINE, int SHADING>
cudaError_t launch2(const Args& a, cudaStream_t stream) {
  if constexpr (SHADING == SHADE_LEGACY) {
    return launch3<AFFINE, SHADING, true>(a, 0, stream);
  } else {
    // the shadow walk's geometry: whole in shared memory where it fits
    const size_t geo_bytes =
        a.shadows ? ((size_t)a.n_tris * 3 + a.n_spheres) * sizeof(float4) : 0;
    if (geo_bytes <= (size_t)GEO_BYTES_MAX) {
      return launch3<AFFINE, SHADING, true>(a, geo_bytes, stream);
    }
    return launch3<AFFINE, SHADING, false>(a, 0, stream);
  }
}

template <bool AFFINE>
cudaError_t launch(const Args& a, int shading, cudaStream_t stream) {
  switch (shading) {
    case SHADE_LEGACY: return launch2<AFFINE, SHADE_LEGACY>(a, stream);
    case SHADE_LAMBERT: return launch2<AFFINE, SHADE_LAMBERT>(a, stream);
    default: return launch2<AFFINE, SHADE_PHONG>(a, stream);
  }
}

}  // namespace

// run_if: null, or an int on the card; then the kernel runs only if it equals
// want, and a skipped launch writes nothing.
extern "C" int octrt_fwd_brute(
    const float* params, const float* tri_geo, const float* tri_attr,
    const float* sph_geo, const float* sph_attr, const float* tri_coef,
    const float* sph_coef, float* out, int height, int width, int tp, int sp,
    int n_tris, int n_spheres, int n_lights, int shading, int shadows,
    int affine, const int* run_if, int want, void* stream) {
  if (shading < SHADE_LEGACY || shading > SHADE_PHONG || n_lights < 1 ||
      height <= 0 || width <= 0 || n_tris < 0 || n_tris > tp ||
      n_spheres < 0 || n_spheres > sp ||
      (affine && (tri_coef == nullptr || sph_coef == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{params, tri_geo, tri_attr, sph_geo, sph_attr, tri_coef, sph_coef,
               reinterpret_cast<float4*>(out), height, width, tp, sp, n_tris,
               n_spheres, n_lights, shadows, run_if, want};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(affine ? launch<true>(a, shading, s) : launch<false>(a, shading, s));
}
