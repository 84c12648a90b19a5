// Brute hard forward frame for Hopper (sm_90a): every pixel against every
// primitive, one thread per pixel.
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
// light, so neither can win a hit or block a shadow ray.
//
// What bounds it on this card: FP32 ALU work, pixels x primitives x (about
// 12 operations per affine test, 45 per general triangle test, 20 per
// general sphere test), against 16 B of output per pixel and a scene of a
// few KB. So the design spends nothing on memory: a block of 256
// consecutive pixels stages the primitives through shared memory, 128 at a
// time in the operands' row-major (row, primitive) layout (coalesced loads;
// every thread then reads the same element: a broadcast), the inner loop
// carries only (t, index), and the winner's attributes are read once per
// pixel by index (the TPU kernel's one-hot matrix product). Shadow loops
// stop a thread at its first occluder and the block once all its threads
// are done.
//
// Numerics: built without --use_fast_math and with -fmad=false, so every
// product and sum rounds once, in the twin's order (ties hang on the last
// bit of t); 1/sqrtf where the twin has 1/torch.sqrt.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CK = 128;    // primitives per shared-memory stage
constexpr int MAXR = 10;   // most rows of a staged operand (sphere coefs)

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
};

// Columns [base, base + n) of a row-major (rows, stride) operand into
// dst[row * CK + j].
__device__ __forceinline__ void stage(float* dst, const float* src, int rows,
                                      int stride, int base, int n) {
  for (int i = threadIdx.x; i < rows * CK; i += THREADS) {
    const int q = i / CK, j = i - q * CK;
    if (j < n) dst[i] = __ldg(src + (size_t)q * stride + base + j);
  }
}

__device__ __forceinline__ float prm(const Args& a, int i) {
  return __ldg(a.params + i);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// --- general tests (fwd.py _tri_chunk_t / _sph_chunk_t), term by term ----
__device__ __forceinline__ bool tri_general(const float* s, int j,
                                            const Ray& r, float& t) {
  const float v0x = s[j], v0y = s[CK + j], v0z = s[2 * CK + j];
  const float e1x = s[3 * CK + j], e1y = s[4 * CK + j], e1z = s[5 * CK + j];
  const float e2x = s[6 * CK + j], e2y = s[7 * CK + j], e2z = s[8 * CK + j];
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

__device__ __forceinline__ bool sph_general(const float* s, int j,
                                            const Ray& r, float& t) {
  const float rad = s[3 * CK + j];
  const float lx = s[j] - r.ox, ly = s[CK + j] - r.oy, lz = s[2 * CK + j] - r.oz;
  const float tca = lx * r.dx + ly * r.dy + lz * r.dz;
  const float m2 = lx * lx + ly * ly + lz * lz - tca * tca;
  const float r2 = rad * rad;
  const bool hit = (tca >= 0.0f) & (m2 <= r2);
  t = tca - sqrtf(fmaxf(r2 - m2, 0.0f));
  return hit & (t != 0.0f);
}

// --- affine tests (fwd.py _tri_chunk_t_affine / _sph_chunk_t_affine) -----
__device__ __forceinline__ bool tri_affine(const float* s, int j, float x,
                                           float y, float& t) {
  const float u = s[j] + x * s[CK + j] + y * s[2 * CK + j];
  const float v = s[3 * CK + j] + x * s[4 * CK + j] + y * s[5 * CK + j];
  t = s[6 * CK + j] + x * s[7 * CK + j] + y * s[8 * CK + j];
  return (u >= 0.0f) & (u <= 1.0f) & (v >= 0.0f) & (u + v <= 1.0f);
}

__device__ __forceinline__ bool sph_affine(const float* s, int j, float x,
                                           float y, float x2, float y2,
                                           float xy, float& t) {
  const float tca = s[j] + x * s[CK + j] + y * s[2 * CK + j];
  const float d2 = s[3 * CK + j] + x * s[4 * CK + j] + y * s[5 * CK + j] +
                   x2 * s[6 * CK + j] + y2 * s[7 * CK + j] + xy * s[8 * CK + j];
  const float r2 = s[9 * CK + j];
  const bool hit = (tca >= 0.0f) & (d2 <= r2);
  t = tca - sqrtf(fmaxf(r2 - d2, 0.0f));
  return hit & (t != 0.0f);
}

// Shadow any-hit over n primitives of one kind: anything in (1e-3, t_max)
// along the ray? `done` threads skip the tests; the block leaves the loop
// once all its threads are done. Every thread of the block must call it.
template <bool SPHERE>
__device__ bool any_occluder(float* smem, const float* geo, int stride, int n,
                             const Ray& r, float t_max, bool done) {
  bool occ = false;
  for (int base = 0; base < n; base += CK) {
    if (__syncthreads_and(done)) break;  // also guards the stage's reuse
    const int m = min(CK, n - base);
    stage(smem, geo, SPHERE ? 4 : 9, stride, base, m);
    __syncthreads();
    if (!done) {
      for (int j = 0; j < m; ++j) {
        float t;
        const bool valid =
            SPHERE ? sph_general(smem, j, r, t) : tri_general(smem, j, r, t);
        if (valid && t > 1e-3f && t < t_max) {
          occ = true;
          done = true;
          break;
        }
      }
    }
  }
  return occ;
}

template <bool AFFINE, int SHADING>
__global__ void __launch_bounds__(THREADS) fwd_brute_kernel(Args a) {
  __shared__ float smem[MAXR * CK];

  const int n_pix = a.height * a.width;
  const int flat = blockIdx.x * THREADS + (int)threadIdx.x;
  const bool inside = flat < n_pix;
  const int pf = inside ? flat : n_pix - 1;  // a valid pixel for the spares
  const int yi = pf / a.width, xi = pf - yi * a.width;
  const float x = (float)xi, y = (float)yi;

  Ray ray;
  ray.ox = prm(a, P_O0) + x * prm(a, P_DOX) + y * prm(a, P_DOY);
  ray.oy = prm(a, P_O0 + 1) + x * prm(a, P_DOX + 1) + y * prm(a, P_DOY + 1);
  ray.oz = prm(a, P_O0 + 2) + x * prm(a, P_DOX + 2) + y * prm(a, P_DOY + 2);
  ray.dx = prm(a, P_D0) + x * prm(a, P_DDX) + y * prm(a, P_DDY);
  ray.dy = prm(a, P_D0 + 1) + x * prm(a, P_DDX + 1) + y * prm(a, P_DDY + 1);
  ray.dz = prm(a, P_D0 + 2) + x * prm(a, P_DDX + 2) + y * prm(a, P_DDY + 2);
  if (!AFFINE) {  // pinhole: per-pixel directions, normalised
    const float inv =
        1.0f / sqrtf(ray.dx * ray.dx + ray.dy * ray.dy + ray.dz * ray.dz);
    ray.dx = ray.dx * inv;
    ray.dy = ray.dy * inv;
    ray.dz = ray.dz * inv;
  }
  const float x2 = x * x, y2 = y * y, xy = x * y;

  // ---- nearest hit: triangles, then spheres (strict <) -----------------
  float best_t = MISS_T;
  int best_idx = 0;
  bool best_sph = false;
  for (int base = 0; base < a.n_tris; base += CK) {
    const int m = min(CK, a.n_tris - base);
    __syncthreads();
    stage(smem, AFFINE ? a.tri_coef : a.tri_geo, 9, a.tp, base, m);
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      float t;
      const bool valid = AFFINE ? tri_affine(smem, j, x, y, t)
                                : tri_general(smem, j, ray, t);
      if (valid && t < best_t) {
        best_t = t;
        best_idx = base + j;
      }
    }
  }
  for (int base = 0; base < a.n_spheres; base += CK) {
    const int m = min(CK, a.n_spheres - base);
    __syncthreads();
    if (AFFINE) stage(smem, a.sph_coef, 10, a.sp, base, m);
    else stage(smem, a.sph_geo, 4, a.sp, base, m);
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      float t;
      const bool valid = AFFINE ? sph_affine(smem, j, x, y, x2, y2, xy, t)
                                : sph_general(smem, j, ray, t);
      if (valid && t < best_t) {
        best_t = t;
        best_idx = base + j;
        best_sph = true;
      }
    }
  }

  // winner attributes, one indexed read per pixel:
  // [r, g, b, nx|cx, ny|cy, nz|cz, 1/rad, is_sphere]
  const bool hit = best_t < MISS_T;
  float at[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (hit) {
    const float* ap = (best_sph ? a.sph_attr : a.tri_attr) + (size_t)best_idx * 8;
#pragma unroll
    for (int q = 0; q < 8; ++q) at[q] = __ldg(ap + q);
  }
  const float t = best_t;

  float r, g, b;
  if (SHADING == SHADE_LEGACY) {
    const float s = 255.0f - t * FOG_K;
    r = hit ? at[0] * s : 0.0f;
    g = hit ? at[1] * s : 0.0f;
    b = hit ? at[2] * s : 0.0f;
  } else {
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
        const bool done = !(hit && inside);
        bool occ = any_occluder<false>(smem, a.tri_geo, a.tp, a.n_tris, sr,
                                       dist, done);
        occ |= any_occluder<true>(smem, a.sph_geo, a.sp, a.n_spheres, sr, dist,
                                  done || occ);
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
    r = fminf(fmaxf(at[0] * (ambient + diff_r) + spec_r, 0.0f), 1.0f) * 255.0f;
    g = fminf(fmaxf(at[1] * (ambient + diff_g) + spec_g, 0.0f), 1.0f) * 255.0f;
    b = fminf(fmaxf(at[2] * (ambient + diff_b) + spec_b, 0.0f), 1.0f) * 255.0f;
    r = hit ? r : 0.0f;
    g = hit ? g : 0.0f;
    b = hit ? b : 0.0f;
  }

  if (inside) a.out[flat] = make_float4(r, g, b, 255.0f);
}

template <bool AFFINE>
void launch(const Args& a, int shading, cudaStream_t stream) {
  const int n_pix = a.height * a.width;
  const dim3 grid((n_pix + THREADS - 1) / THREADS), block(THREADS);
  switch (shading) {
    case SHADE_LEGACY:
      fwd_brute_kernel<AFFINE, SHADE_LEGACY><<<grid, block, 0, stream>>>(a);
      break;
    case SHADE_LAMBERT:
      fwd_brute_kernel<AFFINE, SHADE_LAMBERT><<<grid, block, 0, stream>>>(a);
      break;
    default:
      fwd_brute_kernel<AFFINE, SHADE_PHONG><<<grid, block, 0, stream>>>(a);
      break;
  }
}

}  // namespace

extern "C" int octrt_fwd_brute(
    const float* params, const float* tri_geo, const float* tri_attr,
    const float* sph_geo, const float* sph_attr, const float* tri_coef,
    const float* sph_coef, float* out, int height, int width, int tp, int sp,
    int n_tris, int n_spheres, int n_lights, int shading, int shadows,
    int affine, void* stream) {
  if (shading < SHADE_LEGACY || shading > SHADE_PHONG || n_lights < 1 ||
      height <= 0 || width <= 0 || n_tris < 0 || n_tris > tp ||
      n_spheres < 0 || n_spheres > sp ||
      (affine && (tri_coef == nullptr || sph_coef == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{params, tri_geo, tri_attr, sph_geo, sph_attr, tri_coef, sph_coef,
               reinterpret_cast<float4*>(out), height, width, tp, sp, n_tris,
               n_spheres, n_lights, shadows};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (affine) {
    launch<true>(a, shading, s);
  } else {
    launch<false>(a, shading, s);
  }
  return (int)cudaGetLastError();
}
