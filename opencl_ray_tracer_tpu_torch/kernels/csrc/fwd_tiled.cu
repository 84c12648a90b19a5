// Tiled hard forward frame for Hopper (sm_90a): one thread per pixel.
//
// Replaces the TPU kernel opencl_ray_tracer_tpu/kernels/fwd_tiled.py:
// _build_tiled_kernel (both its packed-word and float-plane outputs, which
// here are one output-format switch). The plain PyTorch twin is
// opencl_ray_tracer_tpu_torch/kernels/fwd_tiled.py:_tiled_kernel_plain; the
// two agree operation for operation.
//
// What it computes, per 64x128 tile that has primary candidates:
//   - rebuilds each pixel's ray from the camera params (affine ray bundle);
//   - nearest hit over the tile's triangle candidates, then its sphere
//     candidates, in ascending primitive index with strict `<` (the first
//     minimal index wins; triangles win ties against spheres), using the
//     per-tile affine (ortho) or projective (pinhole) coefficient rows;
//   - legacy depth fog, or lambert/phong with hard shadows over the
//     (light, tile) shadow lists: four frustum planes per triangle and a
//     segment test per sphere;
//   - writes packed int32 RGBA words (channels clamped to [0, 255] then
//     truncated, alpha 255) or float RGBA, only where the pixel is inside
//     the frame. An empty tile stores the background and returns.
//
// What bounds it on this card: FP32 ALU work per (pixel, candidate) — about
// a dozen multiply/adds and compares per primary test, ~25 per shadow test —
// while the output is only 4 B (packed) or 16 B (float) per pixel and the
// candidate tables are a few KB per tile. The design therefore spends
// nothing on memory tricks: a block covers two rows of one tile (so a
// 1080p frame launches 32 blocks per tile, far more than 132 SMs), the block
// stages its tile's candidate rows through shared memory 64 rows at a time
// (every thread then reads the same row: a broadcast, no bank conflicts),
// the inner loop carries only (t, index) and the winner's attributes are
// read once per pixel, by index, after the loops. Shadow loops stop a
// thread at its first occluder and stop the block once every thread of it
// is done. Pinhole shadow tables are one table shared by all tiles, staged
// through the same 64-row buffer.
//
// Numerics: built without --use_fast_math and with -fmad=false, so each
// product and sum rounds once as in the float32 twin (contracting a + x*b
// into an FMA flips edge pixels of the u/v tests); 1/sqrtf in place of
// rsqrtf; expf/logf for the phong power. Legacy fog may go negative for
// t > 180 in the float output, as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_H = 64;
constexpr int TILE_W = 128;
constexpr int BLOCK_ROWS = 2;
constexpr int THREADS = TILE_W * BLOCK_ROWS;  // 256
constexpr int GROUPS = TILE_H / BLOCK_ROWS;   // row groups (blocks) per tile
constexpr int STAGE = 64;                     // candidate rows per smem stage
constexpr int ROW = 16;                       // floats per table row

constexpr float MISS_T = 300000.0f;
constexpr float EPSILON = 1e-6f;
constexpr float SH_PLANE_EPS = 1e-2f;
constexpr float FOG_K = (float)(255.0 / 180.0);

// params layout (kernels/fwd.py _P_*)
constexpr int P_O0 = 0, P_D0 = 9, P_DDX = 12, P_DDY = 15;
constexpr int P_AMBIENT = 18, P_SPEC = 19, P_SHINE = 20;
constexpr int P_LIGHTS = 21, LIGHT_STRIDE = 7;

enum { SHADE_LEGACY = 0, SHADE_LAMBERT = 1, SHADE_PHONG = 2 };

struct Args {
  const float* params;
  const int* counts;      // (n_tiles, 2 + 2L)
  const float* tri_coef;  // (n_tiles, k_tri, 16)
  const float* tri_attr;  // (n_tiles, k_tri, 8)
  const float* sph_coef;  // (n_tiles, k_sph, 16)
  const float* sph_attr;  // (n_tiles, k_sph, 8)
  const float* tri_sh;    // (n_tiles | 1, L * sh_tri_stride, 16)
  const float* sph_sh;    // (n_tiles | 1, L * sh_sph_stride, 16)
  void* out;              // (H, W) int32 words or (H, W, 4) float32
  int height, width, ntx;
  int k_tri, k_sph, sh_tri_stride, sh_sph_stride, n_lights;
  int shadows, packed_out;
};

// Copy n rows of 16 floats into shared memory, 16 bytes per thread access.
__device__ __forceinline__ void stage_rows(float4* dst, const float* src,
                                           int n) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < n * (ROW / 4); i += THREADS) {
    dst[i] = __ldg(s4 + i);
  }
}

__device__ __forceinline__ float prm(const Args& a, int i) {
  return __ldg(a.params + i);
}

// --- primary tests (fwd_tiled.py tri_affine / sph_affine / tri_proj /
// sph_proj); operation order matches the twin term by term ---------------
__device__ __forceinline__ bool tri_affine(const float* c, float x, float y,
                                           float& t) {
  float u = c[0] + x * c[1] + y * c[2];
  float v = c[3] + x * c[4] + y * c[5];
  t = c[6] + x * c[7] + y * c[8];
  return (u >= 0.0f) & (u <= 1.0f) & (v >= 0.0f) & (u + v <= 1.0f);
}

__device__ __forceinline__ bool sph_affine(const float* c, float x, float y,
                                           float x2, float y2, float xy,
                                           float& t) {
  float tca = c[0] + x * c[1] + y * c[2];
  float d2 = c[3] + x * c[4] + y * c[5] + x2 * c[6] + y2 * c[7] + xy * c[8];
  bool hit = (tca >= 0.0f) & (d2 <= c[9]);
  float thc = sqrtf(fmaxf(c[9] - d2, 0.0f));
  t = tca - thc;
  return hit & (t != 0.0f);
}

__device__ __forceinline__ bool tri_proj(const float* c, float x, float y,
                                         float len_d, float& t) {
  float det = c[0] + x * c[1] + y * c[2];
  float un = c[3] + x * c[4] + y * c[5];
  float vn = c[6] + x * c[7] + y * c[8];
  float sgn = det >= 0.0f ? 1.0f : -1.0f;
  float dets = det * sgn, uns = un * sgn, vns = vn * sgn;
  bool valid = (dets >= EPSILON * len_d) & (uns >= 0.0f) & (vns >= 0.0f) &
               (uns + vns <= dets);
  t = c[9] / (valid ? det : 1.0f) * len_d;
  return valid;
}

__device__ __forceinline__ bool sph_proj(const float* c, float x, float y,
                                         float inv_len, float& t) {
  float tca = (c[0] + x * c[1] + y * c[2]) * inv_len;
  float d2 = c[3] - tca * tca;
  bool hit = (tca >= 0.0f) & (d2 <= c[4]);
  float thc = sqrtf(fmaxf(c[4] - d2, 0.0f));
  t = tca - thc;
  return hit & (t != 0.0f);
}

// --- shadow tests ------------------------------------------------------
struct ShadowRay {
  float x, y, t;            // pixel coords + primary hit distance
  float px, py, pz;         // hit point
  float ldx, ldy, ldz;      // unit direction to the light
  float dist;               // distance to the light
  float o0x, o0y, o0z;      // camera origin
  float dx, dy, dz;         // ortho: shared d0; pinhole: unit pixel dir
};

template <bool PROJ>
__device__ __forceinline__ bool tri_shadow(const float* c,
                                           const ShadowRay& r) {
  bool blocked = true;
#pragma unroll
  for (int pi = 0; pi < 4; ++pi) {
    float mx = c[4 * pi], my = c[4 * pi + 1], mz = c[4 * pi + 2];
    float cc = c[4 * pi + 3];
    float md = mx * r.dx + my * r.dy + mz * r.dz;
    float s = cc + mx * r.o0x + my * r.o0y + mz * r.o0z;
    if (!PROJ) s = s + mx * r.x + my * r.y;
    s = s + md * r.t;
    blocked &= s >= (pi == 3 ? SH_PLANE_EPS : 0.0f);
  }
  return blocked;
}

__device__ __forceinline__ bool sph_shadow(const float* c,
                                           const ShadowRay& r) {
  float lx = c[0] - r.px, ly = c[1] - r.py, lz = c[2] - r.pz;
  float r2 = c[3];
  float tca = lx * r.ldx + ly * r.ldy + lz * r.ldz;
  float m2 = lx * lx + ly * ly + lz * lz - tca * tca;
  bool hit = (tca >= 0.0f) & (m2 <= r2);
  float t0 = tca - sqrtf(fmaxf(r2 - m2, 0.0f));
  return hit & (t0 > 1e-3f) & (t0 < r.dist);
}

// Any-hit over n table rows, staged through shared memory. `done` threads
// (already occluded, or needing no test) skip the work; the block leaves
// the loop once all of its threads are done. Must be reached by every
// thread of the block (it holds barriers).
template <bool PROJ, bool SPHERE>
__device__ bool any_occluder(float4* stage, const float* rows, int n,
                             const ShadowRay& r, bool done) {
  bool occ = false;
  for (int base = 0; base < n; base += STAGE) {
    if (__syncthreads_and(done)) break;  // also guards stage reuse
    const int m = min(STAGE, n - base);
    stage_rows(stage, rows + (size_t)base * ROW, m);
    __syncthreads();
    if (!done) {
      const float* s = reinterpret_cast<const float*>(stage);
      for (int j = 0; j < m; ++j) {
        bool b = SPHERE ? sph_shadow(s + j * ROW, r)
                        : tri_shadow<PROJ>(s + j * ROW, r);
        if (b) {
          occ = true;
          done = true;
          break;
        }
      }
    }
  }
  return occ;
}

template <bool PROJ, int SHADING>
__global__ void __launch_bounds__(THREADS) fwd_tiled_kernel(Args a) {
  __shared__ float4 stage[STAGE * ROW / 4];
  const float* srow = reinterpret_cast<const float*>(stage);

  const int tile = blockIdx.x / GROUPS;
  const int group = blockIdx.x - tile * GROUPS;
  const int ty = tile / a.ntx;
  const int tx = tile - ty * a.ntx;
  const int xi = tx * TILE_W + (int)(threadIdx.x % TILE_W);
  const int yi = ty * TILE_H + group * BLOCK_ROWS + (int)(threadIdx.x / TILE_W);
  const bool inside = xi < a.width && yi < a.height;
  const size_t pix = (size_t)yi * a.width + xi;

  const int n_counts = 2 + 2 * a.n_lights;
  const int* cnt = a.counts + (size_t)tile * n_counts;
  const int cnt_tri = __ldg(cnt), cnt_sph = __ldg(cnt + 1);

  if (cnt_tri + cnt_sph == 0) {  // block-uniform: background, no tests
    if (inside) {
      if (a.packed_out) {
        reinterpret_cast<uint32_t*>(a.out)[pix] = 0xFF000000u;
      } else {
        reinterpret_cast<float4*>(a.out)[pix] =
            make_float4(0.0f, 0.0f, 0.0f, 255.0f);
      }
    }
    return;
  }

  const float x = (float)xi, y = (float)yi;
  const float d0x = prm(a, P_D0), d0y = prm(a, P_D0 + 1), d0z = prm(a, P_D0 + 2);
  const float o0x = prm(a, P_O0), o0y = prm(a, P_O0 + 1), o0z = prm(a, P_O0 + 2);

  // per-pixel ray terms shared by every candidate test
  float dux = 0.f, duy = 0.f, duz = 0.f, inv_len = 0.f, len_d = 0.f;
  float x2 = 0.f, y2 = 0.f, xy = 0.f;
  if (PROJ) {
    dux = d0x + x * prm(a, P_DDX) + y * prm(a, P_DDY);
    duy = d0y + x * prm(a, P_DDX + 1) + y * prm(a, P_DDY + 1);
    duz = d0z + x * prm(a, P_DDX + 2) + y * prm(a, P_DDY + 2);
    float len2 = fmaxf(dux * dux + duy * duy + duz * duz, 1e-20f);
    inv_len = 1.0f / sqrtf(len2);
    len_d = len2 * inv_len;
  } else {
    x2 = x * x;
    y2 = y * y;
    xy = x * y;
  }

  // ---- nearest hit: triangles, then spheres (strict <) -----------------
  float best_t = MISS_T;
  int best_idx = 0;
  bool best_sph = false;
  const float* tri_tab = a.tri_coef + (size_t)tile * a.k_tri * ROW;
  for (int base = 0; base < cnt_tri; base += STAGE) {
    const int m = min(STAGE, cnt_tri - base);
    __syncthreads();
    stage_rows(stage, tri_tab + (size_t)base * ROW, m);
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      float t;
      bool valid = PROJ ? tri_proj(srow + j * ROW, x, y, len_d, t)
                        : tri_affine(srow + j * ROW, x, y, t);
      if (valid && t < best_t) {
        best_t = t;
        best_idx = base + j;
      }
    }
  }
  const float* sph_tab = a.sph_coef + (size_t)tile * a.k_sph * ROW;
  for (int base = 0; base < cnt_sph; base += STAGE) {
    const int m = min(STAGE, cnt_sph - base);
    __syncthreads();
    stage_rows(stage, sph_tab + (size_t)base * ROW, m);
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      float t;
      bool valid = PROJ ? sph_proj(srow + j * ROW, x, y, inv_len, t)
                        : sph_affine(srow + j * ROW, x, y, x2, y2, xy, t);
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
    const float* ap =
        best_sph ? a.sph_attr + ((size_t)tile * a.k_sph + best_idx) * 8
                 : a.tri_attr + ((size_t)tile * a.k_tri + best_idx) * 8;
#pragma unroll
    for (int q = 0; q < 8; ++q) at[q] = __ldg(ap + q);
  }
  const float t = best_t;

  float r, g, b;
  if (SHADING == SHADE_LEGACY) {
    float s = 255.0f - t * FOG_K;
    r = hit ? at[0] * s : 0.0f;
    g = hit ? at[1] * s : 0.0f;
    b = hit ? at[2] * s : 0.0f;
  } else {
    float rdx, rdy, rdz, px, py, pz, vx, vy, vz;
    if (PROJ) {
      rdx = dux * inv_len;
      rdy = duy * inv_len;
      rdz = duz * inv_len;
      px = o0x + t * rdx;
      py = o0y + t * rdy;
      pz = o0z + t * rdz;
      vx = -rdx;
      vy = -rdy;
      vz = -rdz;
    } else {
      rdx = d0x;
      rdy = d0y;
      rdz = d0z;
      px = o0x + x + t * d0x;
      py = o0y + y + t * d0y;
      pz = o0z + t * d0z;
      float vinv = 1.0f / sqrtf(fmaxf(d0x * d0x + d0y * d0y + d0z * d0z, 1e-20f));
      vx = -d0x * vinv;
      vy = -d0y * vinv;
      vz = -d0z * vinv;
    }
    const float ax = at[3], ay = at[4], az = at[5];
    const float nsx = (px - ax) * at[6];
    const float nsy = (py - ay) * at[6];
    const float nsz = (pz - az) * at[6];
    const float flip = (ax * rdx + ay * rdy + az * rdz > 0.0f) ? -1.0f : 1.0f;
    const bool is_sph = at[7] > 0.5f;
    float nx = is_sph ? nsx : ax * flip;
    float ny = is_sph ? nsy : ay * flip;
    float nz = is_sph ? nsz : az * flip;
    const float ninv = 1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-20f));
    nx = nx * ninv;
    ny = ny * ninv;
    nz = nz * ninv;

    const float ambient = prm(a, P_AMBIENT);
    const float spec_k = prm(a, P_SPEC);
    const float shine = prm(a, P_SHINE);
    float diff_r = 0.f, diff_g = 0.f, diff_b = 0.f;
    float spec_r = 0.f, spec_g = 0.f, spec_b = 0.f;
    ShadowRay sr{x, y, t, px, py, pz, 0.f, 0.f, 0.f, 0.f, o0x, o0y, o0z,
                 rdx, rdy, rdz};
    for (int li = 0; li < a.n_lights; ++li) {
      const int base = P_LIGHTS + li * LIGHT_STRIDE;
      const float tlx = prm(a, base) - px;
      const float tly = prm(a, base + 1) - py;
      const float tlz = prm(a, base + 2) - pz;
      const float lcr = prm(a, base + 3), lcg = prm(a, base + 4);
      const float lcb = prm(a, base + 5), lint = prm(a, base + 6);
      const float tl2 = fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-20f);
      const float rinv = 1.0f / sqrtf(tl2);
      const float ldx = tlx * rinv, ldy = tly * rinv, ldz = tlz * rinv;

      float vis = 1.0f;
      if (a.shadows) {  // block-uniform
        sr.ldx = ldx;
        sr.ldy = ldy;
        sr.ldz = ldz;
        sr.dist = tl2 * rinv;
        const size_t tile_off = PROJ ? 0 : (size_t)tile;
        const float* tri_rows =
            a.tri_sh + (tile_off * a.n_lights + li) * a.sh_tri_stride * ROW;
        const float* sph_rows =
            a.sph_sh + (tile_off * a.n_lights + li) * a.sh_sph_stride * ROW;
        bool done = !(hit && inside);
        bool occ = any_occluder<PROJ, false>(stage, tri_rows,
                                             __ldg(cnt + 2 + 2 * li), sr, done);
        occ |= any_occluder<PROJ, true>(stage, sph_rows,
                                        __ldg(cnt + 3 + 2 * li), sr,
                                        done || occ);
        vis = occ ? 0.0f : 1.0f;
      }
      const float ndl = nx * ldx + ny * ldy + nz * ldz;
      const float ndotl = fmaxf(ndl, 0.0f);
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

  if (!inside) return;
  if (a.packed_out) {
    const uint32_t ri = (uint32_t)(int)fminf(fmaxf(r, 0.0f), 255.0f);
    const uint32_t gi = (uint32_t)(int)fminf(fmaxf(g, 0.0f), 255.0f);
    const uint32_t bi = (uint32_t)(int)fminf(fmaxf(b, 0.0f), 255.0f);
    reinterpret_cast<uint32_t*>(a.out)[pix] =
        ri | (gi << 8) | (bi << 16) | 0xFF000000u;
  } else {
    reinterpret_cast<float4*>(a.out)[pix] = make_float4(r, g, b, 255.0f);
  }
}

template <bool PROJ>
void launch(const Args& a, int shading, int n_tiles, cudaStream_t stream) {
  const dim3 grid(n_tiles * GROUPS), block(THREADS);
  switch (shading) {
    case SHADE_LEGACY:
      fwd_tiled_kernel<PROJ, SHADE_LEGACY><<<grid, block, 0, stream>>>(a);
      break;
    case SHADE_LAMBERT:
      fwd_tiled_kernel<PROJ, SHADE_LAMBERT><<<grid, block, 0, stream>>>(a);
      break;
    default:
      fwd_tiled_kernel<PROJ, SHADE_PHONG><<<grid, block, 0, stream>>>(a);
      break;
  }
}

}  // namespace

extern "C" int octrt_fwd_tiled(
    const float* params, const int* counts, const float* tri_coef,
    const float* tri_attr, const float* sph_coef, const float* sph_attr,
    const float* tri_sh, const float* sph_sh, void* out, int height, int width,
    int ntx, int n_tiles, int k_tri, int k_sph, int sh_tri_stride,
    int sh_sph_stride, int n_lights, int shading, int shadows, int projective,
    int out_format, void* stream) {
  if (shading < SHADE_LEGACY || shading > SHADE_PHONG || n_tiles <= 0 ||
      n_lights < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{params, counts, tri_coef, tri_attr, sph_coef, sph_attr, tri_sh,
         sph_sh, out, height, width, ntx, k_tri, k_sph, sh_tri_stride,
         sh_sph_stride, n_lights, shadows, out_format == 0};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (projective) {
    launch<true>(a, shading, n_tiles, s);
  } else {
    launch<false>(a, shading, n_tiles, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* octrt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
