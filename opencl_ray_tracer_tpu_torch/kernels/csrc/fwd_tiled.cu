// Tiled hard forward frame for Hopper (sm_90a): the non-empty tiles only.
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
//     the frame. An empty tile holds the background.
//
// What bounds it on this card: the bytes of the frame it writes (4 B a
// pixel packed, 16 B float: every pixel, lit or not) against few operations:
// on the headline frame 27 of 255 tiles hold candidates, a handful each,
// and 0.8% of the pixels are lit. So the design spends nothing on pixels that
// need nothing:
//   - the kernel's blocks, as many as fit on the card at once, each list the
//     non-empty tiles from the counts in shared memory (tile_list.cuh: no
//     list kernel before it) and take their turns of that list's units:
//     groups of 8 x 4 patches of the non-empty tiles, then the empty tiles,
//     which a block fills with the background word. No block is launched
//     for an empty tile; no pixel is written twice;
//   - a warp walks one 8 x 4 patch, a lane a pixel, so that the pixels
//     that share a fate (hit or missed, lit or occluded) are neighbours;
//   - a block stages its tile's rows (candidates and every light's
//     occluders, 64 B each) in shared memory once per group, and its warps
//     then read them as 128-bit broadcasts with no block barrier in any row
//     loop: the tests are a few operations a row, so a row read through L1
//     costs more than the test (on one H100, rows through L1 took 22% more
//     time on the 1080p headline frame and 16% more at 1,300 primitives). A
//     frame whose tables are wider than STAGE_BYTES_MAX reads them through
//     L1 instead;
//   - a sphere's root and a pinhole triangle's divide are taken only where
//     the test passed (t is read nowhere else);
//   - a pixel that hit nothing takes no ray, shading or shadow arithmetic;
//     a lit pixel walks its tile's shadow rows to its first occluder on its
//     own (the warp leaves once none of its lanes is left), no barrier;
//   - the inner loop carries only (t, index) per pixel, and the winner's
//     attributes are read once per lit pixel, by index.
//
// The pinhole shadow rows are one table that every tile shares: all the
// frame's primitives, since a pinhole tile's hit points are not known
// before the frame is traced. So each warp culls them against its own hit
// points (`cull_rows`), once a warp and light, before any lane walks:
//   - it engages where the warp has a lit lane (a hit inside the frame;
//     phong or lambert with shadows) and the light's list holds more rows
//     than a warp has lanes (CULL_MIN_ROWS); the condition is warp-uniform;
//   - the warp reduces the box [lo, hi] of its lit lanes' hit points p,
//     computed as `shade` computes them (`proj_hit`), by shuffles; its
//     lanes then test the light's rows, row j on lane j % 32, once each:
//     a triangle is dropped where one of its four planes' largest value
//     over the box, sum_i max(m_i lo_i, m_i hi_i) + w, lies below the
//     walk's threshold (0, or SH_PLANE_EPS for the triangle's plane) by
//     more than CULL_SLACK * (|w| + |m|_1 * 2 (|o0|_1 + P)), P the box's
//     largest |p|_1; a sphere is kept where its box, padded, meets the hull
//     of the hit box and the light (one s-interval a coordinate, s in
//     [0, 1] along the segments from the box to the light);
//   - the kept rows are one bit each in the warp's words of shared memory
//     (__ballot_sync), and `occluded` walks only those, in ascending row
//     order, through the same tests: a lane still leaves at its first
//     occluder, and since the answer is any-hit, every frame word is the
//     one the whole walk gives;
//   - the cull may keep too much, never too little. The margins cover the
//     walk's own rounding. The walk evaluates a plane at o0 + t rd in its
//     order, B1's box holds p = o0 + t rd as `shade` rounds it: the two
//     differ by a few ulps of |w| + |o0| + t + |p| (t <= |o0|_1 + P), and
//     the cull's own sum by as many: CULL_SLACK = 2^-16 is over 20 times
//     that. The sphere test's m2 = |l|^2 - tca^2 cancels: a row the walk
//     marks blocked has its entry point within r + 1.31e-3 (D + r) of the
//     centre (D the farthest of the box from it, from u = 2^-24: about
//     sqrt(28.5 u) D, the rest in ulps), so the sphere's radius is padded
//     by CULL_SPH_PAD (D + r), CULL_SPH_PAD = 2^-8 three times that, then
//     by CULL_SLACK times the coordinates' size for the segment's end
//     (within 8 ulps of the light) and the s-intervals' rounding;
//   - each block adds its warps' rows and kept rows to the card counters
//     b1.shadow_rows and b1.shadow_rows_kept (Args::stats) once, at its end.
//
// Numerics: built without --use_fast_math and with -fmad=false, so each
// product and sum rounds once as in the float32 twin (contracting a + x*b
// into an FMA flips edge pixels of the u/v tests); 1/sqrtf in place of
// rsqrtf; expf/logf for the phong power. Legacy fog may go negative for
// t > 180 in the float output, as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_list.cuh"

namespace {

namespace tl = octrt_tiles;

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int ROW4 = 4;   // float4s per table row (16 floats)
constexpr int GROUPS = tl::TILE_PATCHES / NWARP;  // units of a non-empty tile
// Blocks a multiprocessor that the compiler must leave registers for.
constexpr int BLOCKS = 4;

constexpr float MISS_T = 300000.0f;
constexpr float EPSILON = 1e-6f;
constexpr float SH_PLANE_EPS = 1e-2f;
constexpr float FOG_K = (float)(255.0 / 180.0);

// The per-warp cull of the pinhole shadow rows (see the header).
constexpr int CULL_MIN_ROWS = 32;            // a light's list longer than a warp
constexpr float CULL_SLACK = 1.0f / 65536;   // of the coordinates' size
constexpr float CULL_SPH_PAD = 1.0f / 256;   // of the sphere's reach

// params layout (kernels/fwd.py _P_*)
constexpr int P_O0 = 0, P_D0 = 9, P_DDX = 12, P_DDY = 15;
constexpr int P_AMBIENT = 18, P_SPEC = 19, P_SHINE = 20;
constexpr int P_LIGHTS = 21, LIGHT_STRIDE = 7;

enum { SHADE_LEGACY = 0, SHADE_LAMBERT = 1, SHADE_PHONG = 2 };

struct Args {
  const float* params;
  const int* counts;       // (n_tiles, 2 + 2L)
  const float4* tri_coef;  // (n_tiles, k_tri, 16)
  const float4* tri_attr;  // (n_tiles, k_tri, 8)
  const float4* sph_coef;  // (n_tiles, k_sph, 16)
  const float4* sph_attr;  // (n_tiles, k_sph, 8)
  const float4* tri_sh;    // (n_tiles | 1, L * sh_tri_stride, 16)
  const float4* sph_sh;    // (n_tiles | 1, L * sh_sph_stride, 16)
  void* out;               // (H, W) int32 words or (H, W, 4) float32
  int height, width, ntx, n_tiles;
  int k_tri, k_sph, sh_tri_stride, sh_sph_stride, n_lights;
  int shadows, packed_out;
  const int* run_if;       // null: always run; else run only if *run_if == want
  int want;                // (lax.cond on the card: the untaken branch returns)
  unsigned long long* stats;  // null, or b1.shadow_rows, b1.shadow_rows_kept
};

__device__ __forceinline__ float prm(const Args& a, int i) {
  return __ldg(a.params + i);
}

// A pinhole pixel's ray terms: the unnormalised direction, 1/|d| and |d|.
struct ProjRay {
  float dux, duy, duz, inv_len, len_d;
};

__device__ __forceinline__ ProjRay proj_ray(const Args& a, float x, float y) {
  ProjRay r;
  r.dux = prm(a, P_D0) + x * prm(a, P_DDX) + y * prm(a, P_DDY);
  r.duy = prm(a, P_D0 + 1) + x * prm(a, P_DDX + 1) + y * prm(a, P_DDY + 1);
  r.duz = prm(a, P_D0 + 2) + x * prm(a, P_DDX + 2) + y * prm(a, P_DDY + 2);
  const float len2 = fmaxf(r.dux * r.dux + r.duy * r.duy + r.duz * r.duz, 1e-20f);
  r.inv_len = 1.0f / sqrtf(len2);
  r.len_d = len2 * r.inv_len;
  return r;
}

// A pinhole pixel's unit ray direction and hit point at t: what `shade`
// lights and the cull bounds.
struct Hit {
  float rdx, rdy, rdz, px, py, pz;
};

__device__ __forceinline__ Hit proj_hit(const Args& a, const ProjRay& pr, float t) {
  Hit h;
  h.rdx = pr.dux * pr.inv_len;
  h.rdy = pr.duy * pr.inv_len;
  h.rdz = pr.duz * pr.inv_len;
  h.px = prm(a, P_O0) + t * h.rdx;
  h.py = prm(a, P_O0 + 1) + t * h.rdy;
  h.pz = prm(a, P_O0 + 2) + t * h.rdz;
  return h;
}

// --- shadow tests (fwd_tiled.py _tri_blocked / _sph_blocked) ------------
struct ShadowRay {
  float x, y, t;            // pixel coords + primary hit distance
  float px, py, pz;         // hit point
  float ldx, ldy, ldz;      // unit direction to the light
  float dist;               // distance to the light
  float o0x, o0y, o0z;      // camera origin
  float dx, dy, dz;         // ortho: shared d0; pinhole: unit pixel dir
};

// Rows are read through plain pointers: into shared memory where the block
// staged its tile's rows, else into device memory.

// The largest dynamic shared memory (the list of tile_list.cuh and a tile's
// rows) in which the kernel stages the rows: four blocks of it fit on a
// multiprocessor. A frame whose tables are wider reads its rows from device
// memory through L1 instead.
constexpr size_t STAGE_BYTES_MAX = 48 * 1024;

// dst[0, n) <- src[0, n) (device memory into shared memory), by the whole
// block, consecutive threads on consecutive float4s.
__device__ __forceinline__ void stage(float4* dst, const float4* src, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = __ldg(src + i);
}

// c: a triangle's shadow row, four planes (mx, my, mz, c) as four float4s
template <bool PROJ>
__device__ __forceinline__ bool tri_shadow(const float4* c,
                                           const ShadowRay& r) {
  bool blocked = true;
#pragma unroll
  for (int pi = 0; pi < 4; ++pi) {
    const float4 pl = c[pi];
    const float md = pl.x * r.dx + pl.y * r.dy + pl.z * r.dz;
    float s = pl.w + pl.x * r.o0x + pl.y * r.o0y + pl.z * r.o0z;
    if (!PROJ) s = s + pl.x * r.x + pl.y * r.y;
    s = s + md * r.t;
    blocked &= s >= (pi == 3 ? SH_PLANE_EPS : 0.0f);
  }
  return blocked;
}

// c: a sphere's shadow row, (centre, r^2) in its first float4
__device__ __forceinline__ bool sph_shadow(const float4* c,
                                           const ShadowRay& r) {
  const float4 s = c[0];
  const float lx = s.x - r.px, ly = s.y - r.py, lz = s.z - r.pz;
  const float r2 = s.w;
  const float tca = lx * r.ldx + ly * r.ldy + lz * r.ldz;
  const float m2 = lx * lx + ly * ly + lz * lz - tca * tca;
  if (!((tca >= 0.0f) & (m2 <= r2))) return false;  // the root only on a hit
  const float t0 = tca - sqrtf(fmaxf(r2 - m2, 0.0f));
  return (t0 > 1e-3f) & (t0 < r.dist);
}

// Any occluder among n triangle then m sphere rows, or among those of them
// that `kept` marks (row j: bit j % 32 of word j / 32; triangles first):
// the lane leaves at its first, the warp once none of its lanes is left.
template <bool PROJ>
__device__ __forceinline__ bool occluded(const float4* tri, int n,
                                         const float4* sph, int m,
                                         const ShadowRay& r,
                                         const unsigned* kept) {
  if (kept == nullptr) {
    for (int j = 0; j < n; ++j) {
      if (tri_shadow<PROJ>(tri + j * ROW4, r)) return true;
    }
    for (int j = 0; j < m; ++j) {
      if (sph_shadow(sph + j * ROW4, r)) return true;
    }
    return false;
  }
  for (int w = 0; w < (n + m + 31) >> 5; ++w) {
    for (unsigned bits = kept[w]; bits != 0u; bits &= bits - 1u) {
      const int j = (w << 5) + __ffs(bits) - 1;
      if (j < n ? tri_shadow<PROJ>(tri + j * ROW4, r)
                : sph_shadow(sph + (j - n) * ROW4, r)) {
        return true;
      }
    }
  }
  return false;
}

// Where a group's walks read their tile's rows: the candidates, and the
// occluders of light 0 (tri, sph), then those of the next light at `step`.
struct TileRows {
  const float4 *tri, *sph, *tri_sh, *sph_sh;
  int n_tri, n_sph;
  size_t tri_sh_step, sph_sh_step;  // float4s from one light's rows to the next
};

// A tile's rows in device memory.
__device__ __forceinline__ TileRows device_rows(const Args& a, int tile,
                                                const int* cnt, bool proj) {
  const size_t sh_tile = proj ? 0 : (size_t)tile;
  TileRows R;
  R.tri = a.tri_coef + (size_t)tile * a.k_tri * ROW4;
  R.sph = a.sph_coef + (size_t)tile * a.k_sph * ROW4;
  R.tri_sh = a.tri_sh + sh_tile * a.n_lights * a.sh_tri_stride * ROW4;
  R.sph_sh = a.sph_sh + sh_tile * a.n_lights * a.sh_sph_stride * ROW4;
  R.n_tri = __ldg(cnt);
  R.n_sph = __ldg(cnt + 1);
  R.tri_sh_step = (size_t)a.sh_tri_stride * ROW4;
  R.sph_sh_step = (size_t)a.sh_sph_stride * ROW4;
  return R;
}

// The float4s of a tile's rows staged in shared memory (`stage_rows`).
__host__ __device__ __forceinline__ size_t staged_float4s(const Args& a) {
  return ((size_t)a.k_tri + a.k_sph +
          (a.shadows ? (size_t)a.n_lights * (a.sh_tri_stride + a.sh_sph_stride) : 0)) *
         ROW4;
}

// The same rows staged in shared memory by the whole block (their real
// counts only, each list packed): candidates, then light after light its
// triangle and sphere occluders at the tables' strides. Every thread of the
// block must call it; the caller's barrier follows.
__device__ TileRows stage_rows(const Args& a, const TileRows& d, const int* cnt,
                               float4* smem) {
  TileRows R = d;
  float4* p = smem;
  stage(p, d.tri, d.n_tri * ROW4);
  R.tri = p;
  p += (size_t)a.k_tri * ROW4;
  stage(p, d.sph, d.n_sph * ROW4);
  R.sph = p;
  p += (size_t)a.k_sph * ROW4;
  R.tri_sh = p;
  R.sph_sh = p + (size_t)a.n_lights * d.tri_sh_step;
  if (a.shadows) {
    for (int li = 0; li < a.n_lights; ++li) {
      stage(const_cast<float4*>(R.tri_sh) + li * d.tri_sh_step,
                d.tri_sh + li * d.tri_sh_step, __ldg(cnt + 2 + 2 * li) * ROW4);
      stage(const_cast<float4*>(R.sph_sh) + li * d.sph_sh_step,
                d.sph_sh + li * d.sph_sh_step, __ldg(cnt + 3 + 2 * li) * ROW4);
    }
  }
  return R;
}

// --- the per-warp cull of the pinhole shadow rows (see the header) --------

// The box of a warp's lit hit points, and the sizes its margins scale with.
struct HitBox {
  float3 lo, hi;
  float reach;  // 2 (|o0|_1 + the box's largest |p|_1): bounds |o0| + t + |p|
  float amax;   // the box's largest |coordinate|
};

// Whether a point of the box can lie inside a triangle's light frustum
// (c: its shadow row, as tri_shadow reads it).
__device__ __forceinline__ bool tri_keep(const float4* c, const HitBox& b) {
#pragma unroll
  for (int pi = 0; pi < 4; ++pi) {
    const float4 pl = c[pi];
    const float top = pl.w + fmaxf(pl.x * b.lo.x, pl.x * b.hi.x) +
                      fmaxf(pl.y * b.lo.y, pl.y * b.hi.y) +
                      fmaxf(pl.z * b.lo.z, pl.z * b.hi.z);
    const float slack =
        CULL_SLACK * (fabsf(pl.w) + (fabsf(pl.x) + fabsf(pl.y) + fabsf(pl.z)) * b.reach);
    if (!(top + slack >= (pi == 3 ? SH_PLANE_EPS : 0.0f))) return false;
  }
  return true;
}

// Narrows [lo, hi] to the s at which the box (1 - s) [b0, b1] + s L of one
// coordinate meets [o0, o1]; false where no s does (fwd_tiled.py
// _axis_s_interval).
__device__ __forceinline__ bool s_range(float b0, float b1, float L, float o0,
                                        float o1, float& lo, float& hi) {
  const float da = L - b0, ra = o1 - b0;  // b0 + s da <= o1
  if (da > 0.0f) {
    hi = fminf(hi, ra / da);
  } else if (da < 0.0f) {
    lo = fmaxf(lo, ra / da);
  } else if (ra < 0.0f) {
    return false;
  }
  const float db = L - b1, rb = o0 - b1;  // b1 + s db >= o0
  if (db > 0.0f) {
    lo = fmaxf(lo, rb / db);
  } else if (db < 0.0f) {
    hi = fminf(hi, rb / db);
  } else if (rb > 0.0f) {
    return false;
  }
  return true;
}

// Whether a sphere (c: its shadow row, centre and r^2) can lie on a segment
// from the box to the light L (lmax: L's largest |coordinate|).
__device__ __forceinline__ bool sph_keep(const float4* c, const HitBox& b,
                                         float3 L, float lmax) {
  const float4 s = c[0];
  const float r = sqrtf(fmaxf(s.w, 0.0f));
  const float fx = fmaxf(fabsf(s.x - b.lo.x), fabsf(s.x - b.hi.x));
  const float fy = fmaxf(fabsf(s.y - b.lo.y), fabsf(s.y - b.hi.y));
  const float fz = fmaxf(fabsf(s.z - b.lo.z), fabsf(s.z - b.hi.z));
  float rad = r + CULL_SPH_PAD * (sqrtf(fx * fx + fy * fy + fz * fz) + r);
  rad = rad + CULL_SLACK * (fmaxf(fmaxf(fabsf(s.x), fabsf(s.y)), fabsf(s.z)) +
                            rad + b.amax + lmax);
  float lo = 0.0f, hi = 1.0f;
  return s_range(b.lo.x, b.hi.x, L.x, s.x - rad, s.x + rad, lo, hi) &&
         s_range(b.lo.y, b.hi.y, L.y, s.y - rad, s.y + rad, lo, hi) &&
         s_range(b.lo.z, b.hi.z, L.z, s.z - rad, s.z + rad, lo, hi) && lo <= hi;
}

// The words of kept rows a warp holds for each light.
__host__ __device__ __forceinline__ int cull_words(const Args& a) {
  return (a.sh_tri_stride + a.sh_sph_stride + 31) >> 5;
}

__device__ __forceinline__ bool culls(const int* cnt, int li) {
  return __ldg(cnt + 2 + 2 * li) + __ldg(cnt + 3 + 2 * li) > CULL_MIN_ROWS;
}

// The warp's cull (see the header): every lane calls it after the
// nearest-hit loops; lit: this lane hit something inside the frame, at t.
// Writes the kept rows of each light that culls to kept + li * cull_words,
// and adds the rows and the kept rows to tally.
__device__ void cull_rows(const Args& a, const TileRows& R, const int* cnt,
                          bool lit, const ProjRay& pr, float t, unsigned* kept,
                          unsigned (&tally)[2]) {
  const unsigned full = 0xffffffffu;
  if (!__any_sync(full, lit)) return;
  const float inf = __int_as_float(0x7f800000);
  HitBox b{make_float3(inf, inf, inf), make_float3(-inf, -inf, -inf), 0.0f, 0.0f};
  if (lit) {
    const Hit h = proj_hit(a, pr, t);
    b.lo = b.hi = make_float3(h.px, h.py, h.pz);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    b.lo.x = fminf(b.lo.x, __shfl_xor_sync(full, b.lo.x, o));
    b.lo.y = fminf(b.lo.y, __shfl_xor_sync(full, b.lo.y, o));
    b.lo.z = fminf(b.lo.z, __shfl_xor_sync(full, b.lo.z, o));
    b.hi.x = fmaxf(b.hi.x, __shfl_xor_sync(full, b.hi.x, o));
    b.hi.y = fmaxf(b.hi.y, __shfl_xor_sync(full, b.hi.y, o));
    b.hi.z = fmaxf(b.hi.z, __shfl_xor_sync(full, b.hi.z, o));
  }
  const float ax = fmaxf(fabsf(b.lo.x), fabsf(b.hi.x));
  const float ay = fmaxf(fabsf(b.lo.y), fabsf(b.hi.y));
  const float az = fmaxf(fabsf(b.lo.z), fabsf(b.hi.z));
  b.amax = fmaxf(fmaxf(ax, ay), az);
  b.reach = 2.0f * (fabsf(prm(a, P_O0)) + fabsf(prm(a, P_O0 + 1)) +
                    fabsf(prm(a, P_O0 + 2)) + ax + ay + az);
  const int lane = threadIdx.x & 31, words = cull_words(a);
  __syncwarp();  // the lanes have walked the last unit's words
  for (int li = 0; li < a.n_lights; ++li) {
    if (!culls(cnt, li)) continue;
    const int n = __ldg(cnt + 2 + 2 * li), m = __ldg(cnt + 3 + 2 * li);
    const float4* tri = R.tri_sh + li * R.tri_sh_step;
    const float4* sph = R.sph_sh + li * R.sph_sh_step;
    const int base = P_LIGHTS + li * LIGHT_STRIDE;
    const float3 L = make_float3(prm(a, base), prm(a, base + 1), prm(a, base + 2));
    const float lmax = fmaxf(fmaxf(fabsf(L.x), fabsf(L.y)), fabsf(L.z));
    unsigned* mine = kept + li * words;
    unsigned n_kept = 0;
    for (int j0 = 0; j0 < n + m; j0 += 32) {
      const int j = j0 + lane;
      bool keep = false;
      if (j < n) {
        keep = tri_keep(tri + j * ROW4, b);
      } else if (j < n + m) {
        keep = sph_keep(sph + (j - n) * ROW4, b, L, lmax);
      }
      const unsigned word = __ballot_sync(full, keep);
      if (lane == 0) mine[j0 >> 5] = word;
      n_kept += __popc(word);
    }
    tally[0] += n + m;
    tally[1] += n_kept;
  }
  __syncwarp();  // the words are written before any lane walks them
}

// The colour (0..255 floats) of a pixel that hit something: t the nearest
// hit, code the triangle's index or ~index of the sphere, in tile `tile`;
// kept: null, or the warp's words of kept shadow rows (`cull_rows`).
template <bool PROJ, int SHADING>
__device__ float3 shade(const Args& a, int tile, const TileRows& R,
                        const int* cnt, float x, float y, float t, int code,
                        const unsigned* kept) {
  // winner attributes, one indexed read: [r, g, b, nx|cx, ny|cy, nz|cz,
  // 1/rad, is_sphere]
  const float4* ap = code < 0
      ? a.sph_attr + ((size_t)tile * a.k_sph + ~code) * 2
      : a.tri_attr + ((size_t)tile * a.k_tri + code) * 2;
  const float4 lo = __ldg(ap), hi = __ldg(ap + 1);
  if (SHADING == SHADE_LEGACY) {
    const float s = 255.0f - t * FOG_K;
    return make_float3(lo.x * s, lo.y * s, lo.z * s);
  }
  const float d0x = prm(a, P_D0), d0y = prm(a, P_D0 + 1), d0z = prm(a, P_D0 + 2);
  const float o0x = prm(a, P_O0), o0y = prm(a, P_O0 + 1), o0z = prm(a, P_O0 + 2);
  float rdx, rdy, rdz, px, py, pz, vx, vy, vz;
  if (PROJ) {
    const Hit h = proj_hit(a, proj_ray(a, x, y), t);
    rdx = h.rdx;
    rdy = h.rdy;
    rdz = h.rdz;
    px = h.px;
    py = h.py;
    pz = h.pz;
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
    const float vinv = 1.0f / sqrtf(fmaxf(d0x * d0x + d0y * d0y + d0z * d0z, 1e-20f));
    vx = -d0x * vinv;
    vy = -d0y * vinv;
    vz = -d0z * vinv;
  }
  const float ax = lo.w, ay = hi.x, az = hi.y;
  const float nsx = (px - ax) * hi.z;
  const float nsy = (py - ay) * hi.z;
  const float nsz = (pz - az) * hi.z;
  const float flip = (ax * rdx + ay * rdy + az * rdz > 0.0f) ? -1.0f : 1.0f;
  const bool is_sph = hi.w > 0.5f;
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
    if (a.shadows) {
      sr.ldx = ldx;
      sr.ldy = ldy;
      sr.ldz = ldz;
      sr.dist = tl2 * rinv;
      const unsigned* mine =
          (kept != nullptr && culls(cnt, li)) ? kept + li * cull_words(a) : nullptr;
      vis = occluded<PROJ>(R.tri_sh + li * R.tri_sh_step, __ldg(cnt + 2 + 2 * li),
                           R.sph_sh + li * R.sph_sh_step, __ldg(cnt + 3 + 2 * li),
                           sr, mine) ? 0.0f : 1.0f;
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
  return make_float3(
      fminf(fmaxf(lo.x * (ambient + diff_r) + spec_r, 0.0f), 1.0f) * 255.0f,
      fminf(fmaxf(lo.y * (ambient + diff_g) + spec_g, 0.0f), 1.0f) * 255.0f,
      fminf(fmaxf(lo.z * (ambient + diff_b) + spec_b, 0.0f), 1.0f) * 255.0f);
}

// Whether B1 culls its pinhole shadow rows (see the header).
template <bool PROJ, int SHADING>
__host__ __device__ __forceinline__ bool culling(const Args& a) {
  return PROJ && SHADING != SHADE_LEGACY && a.shadows;
}

// The pixel (xi, yi) of tile `tile`, its rows at R: nearest hit, then its
// colour, written where it lies inside the frame. The warp's lanes call it
// together; kept: the warp's words of kept shadow rows, tally: its counts.
template <bool PROJ, int SHADING>
__device__ __forceinline__ void pixel(const Args& a, int tile, const TileRows& R,
                                      const int* cnt, int xi, int yi,
                                      unsigned* kept, unsigned (&tally)[2]) {
  const float x = (float)xi, y = (float)yi;
  float best_t = MISS_T;
  int best = 0;  // the triangle's index, or ~index of a sphere
  ProjRay pr;
  if (PROJ) pr = proj_ray(a, x, y);

  // ---- nearest hit: triangles, then spheres (strict <) -------------------
  for (int j = 0; j < R.n_tri; ++j) {
    const float4* c = R.tri + j * ROW4;
    const float4 A = c[0], B = c[1], C = c[2];
    if (PROJ) {  // fwd_tiled.py tri_proj: det, un, vn projective in (x, y)
      const float det = A.x + x * A.y + y * A.z;
      const float un = A.w + x * B.x + y * B.y;
      const float vn = B.z + x * B.w + y * C.x;
      const float sgn = det >= 0.0f ? 1.0f : -1.0f;
      const float dets = det * sgn, uns = un * sgn, vns = vn * sgn;
      const bool valid = (dets >= EPSILON * pr.len_d) & (uns >= 0.0f) &
                         (vns >= 0.0f) & (uns + vns <= dets);
      if (valid) {  // the divide only on a hit
        const float t = C.y / det * pr.len_d;
        if (t < best_t) {
          best_t = t;
          best = j;
        }
      }
    } else {  // fwd_tiled.py tri_affine: u, v, t affine in (x, y)
      const float u = A.x + x * A.y + y * A.z;
      const float v = A.w + x * B.x + y * B.y;
      const float t = B.z + x * B.w + y * C.x;
      const bool valid = (u >= 0.0f) & (u <= 1.0f) & (v >= 0.0f) & (u + v <= 1.0f);
      if (valid && t < best_t) {
        best_t = t;
        best = j;
      }
    }
  }
  for (int j = 0; j < R.n_sph; ++j) {
    const float4* c = R.sph + j * ROW4;
    const float4 A = c[0], B = c[1];
    float tca, d2, r2;
    if (PROJ) {  // sph_proj: tca projective, d2 from it
      tca = (A.x + x * A.y + y * A.z) * pr.inv_len;
      d2 = A.w - tca * tca;
      r2 = B.x;
    } else {  // sph_affine: tca affine, d2 quadratic in (x, y)
      const float4 C = c[2];
      tca = A.x + x * A.y + y * A.z;
      d2 = A.w + x * B.x + y * B.y + (x * x) * B.z + (y * y) * B.w + (x * y) * C.x;
      r2 = C.y;
    }
    if ((tca >= 0.0f) & (d2 <= r2)) {  // the root only on a hit
      const float t = tca - sqrtf(fmaxf(r2 - d2, 0.0f));
      if (t != 0.0f && t < best_t) {
        best_t = t;
        best = ~j;
      }
    }
  }

  const bool inside = xi < a.width && yi < a.height;
  const bool cull = culling<PROJ, SHADING>(a);
  if (cull) cull_rows(a, R, cnt, inside && best_t < MISS_T, pr, best_t, kept, tally);
  if (!inside) return;
  float3 col = make_float3(0.0f, 0.0f, 0.0f);  // nothing hit: the background
  if (best_t < MISS_T) {
    col = shade<PROJ, SHADING>(a, tile, R, cnt, x, y, best_t, best,
                               cull ? kept : nullptr);
  }
  const size_t pix = (size_t)yi * a.width + xi;
  if (a.packed_out) {
    const uint32_t ri = (uint32_t)(int)fminf(fmaxf(col.x, 0.0f), 255.0f);
    const uint32_t gi = (uint32_t)(int)fminf(fmaxf(col.y, 0.0f), 255.0f);
    const uint32_t bi = (uint32_t)(int)fminf(fmaxf(col.z, 0.0f), 255.0f);
    reinterpret_cast<uint32_t*>(a.out)[pix] =
        ri | (gi << 8) | (bi << 16) | 0xFF000000u;
  } else {
    reinterpret_cast<float4*>(a.out)[pix] = make_float4(col.x, col.y, col.z, 255.0f);
  }
}

// STAGED: the block stages each group's tile's rows in shared memory first.
template <bool PROJ, int SHADING, bool STAGED>
__global__ void __launch_bounds__(THREADS, BLOCKS) fwd_tiled_kernel(Args a,
                                                                    int* tiles) {
  if (a.run_if != nullptr && __ldg(a.run_if) != a.want) return;  // see Args::run_if
  // the list, then the staged rows, then each warp's words of kept rows
  extern __shared__ float4 s_dyn[];
  __shared__ int s_cnt[NWARP];
  int* s_list = reinterpret_cast<int*>(s_dyn);
  float4* s_rows = s_dyn + tl::list_float4s(a.n_tiles);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* s_kept = reinterpret_cast<unsigned*>(s_rows + (STAGED ? staged_float4s(a) : 0)) +
                     (size_t)warp * a.n_lights * cull_words(a);
  unsigned tally[2] = {0u, 0u};  // this warp's culled rows and kept rows
  const int n_live =
      tl::block_list(a.counts, 2 + 2 * a.n_lights, a.n_tiles, s_list, s_cnt);
  if (blockIdx.x == 0) tl::write_list(tiles, s_list, n_live, a.n_tiles);
  const tl::Units U(s_list, n_live, a.n_tiles, GROUPS);
  for (int unit = blockIdx.x; unit < U.n_units; unit += gridDim.x) {
    if (U.is_group(unit)) {
      const int tile = U.group_tile(unit);
      const int* cnt = a.counts + (size_t)tile * (2 + 2 * a.n_lights);
      TileRows R = device_rows(a, tile, cnt, PROJ);
      if (STAGED) {
        R = stage_rows(a, R, cnt, s_rows);
        __syncthreads();
      }
      const int patch = U.group_patch(unit) + warp;
      const int ty = tile / a.ntx, tx = tile - ty * a.ntx;
      pixel<PROJ, SHADING>(
          a, tile, R, cnt,
          tx * tl::TILE_W + (patch % tl::PATCHES_X) * tl::PATCH_W + (lane & 7),
          ty * tl::TILE_H + (patch / tl::PATCHES_X) * tl::PATCH_H + (lane >> 3),
          s_kept, tally);
      if (STAGED) __syncthreads();  // read before the next group stages
    } else if (a.packed_out) {
      tl::fill_tile(reinterpret_cast<uint32_t*>(a.out), U.empty_tile(unit), a.ntx,
                    a.height, a.width, 0xFF000000u);
    } else {
      tl::fill_tile(reinterpret_cast<float4*>(a.out), U.empty_tile(unit), a.ntx,
                    a.height, a.width, make_float4(0.0f, 0.0f, 0.0f, 255.0f));
    }
  }
  if (culling<PROJ, SHADING>(a) && a.stats != nullptr) {  // one add a block
    __shared__ unsigned s_tally[NWARP][2];
    if (lane == 0) {
      s_tally[warp][0] = tally[0];
      s_tally[warp][1] = tally[1];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long rows = 0, n_kept = 0;
      for (int w = 0; w < NWARP; ++w) {
        rows += s_tally[w][0];
        n_kept += s_tally[w][1];
      }
      if (rows != 0) {
        atomicAdd(a.stats, rows);
        atomicAdd(a.stats + 1, n_kept);
      }
    }
  }
}

template <bool PROJ, int SHADING, bool STAGED>
cudaError_t launch3(const Args& a, size_t smem, int* tiles, cudaStream_t s) {
  auto kernel = fwd_tiled_kernel<PROJ, SHADING, STAGED>;
  int grid = 0;
  const cudaError_t err = tl::resident_grid(kernel, THREADS, smem,
                                            (long long)a.n_tiles * GROUPS, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, s>>>(a, tiles);
  return cudaGetLastError();
}

// A tile's rows in shared memory where the tables' widths fit in
// STAGE_BYTES_MAX: candidates, and every light's occluders if shadows are on.
// The warps' words of kept shadow rows follow, where B1 culls.
template <bool PROJ, int SHADING>
cudaError_t launch2(const Args& a, int* tiles, cudaStream_t s) {
  const size_t list = (size_t)tl::list_float4s(a.n_tiles) * sizeof(float4);
  const size_t staged = list + staged_float4s(a) * sizeof(float4);
  const size_t kept = culling<PROJ, SHADING>(a)
                          ? (size_t)NWARP * a.n_lights * cull_words(a) * sizeof(unsigned)
                          : 0;
  if (staged <= STAGE_BYTES_MAX) {
    return launch3<PROJ, SHADING, true>(a, staged + kept, tiles, s);
  }
  return launch3<PROJ, SHADING, false>(a, list + kept, tiles, s);
}

template <bool PROJ>
cudaError_t launch(const Args& a, int shading, int* tiles, cudaStream_t s) {
  switch (shading) {
    case SHADE_LEGACY: return launch2<PROJ, SHADE_LEGACY>(a, tiles, s);
    case SHADE_LAMBERT: return launch2<PROJ, SHADE_LAMBERT>(a, tiles, s);
    default: return launch2<PROJ, SHADE_PHONG>(a, tiles, s);
  }
}

}  // namespace

// tiles: 2 + n_tiles ints; it comes back as the list of tile_list.cuh
// (the number of non-empty tiles, a zero, the tiles). run_if: null, or an int
// on the card; then the kernel runs only if it equals want, and a skipped
// launch writes neither out nor tiles. stats: null, or two int64 counters on
// the card, to which a launch that culls (a pinhole frame with shadows, see
// the header) adds the shadow rows its warps culled and the rows they kept;
// any other launch leaves them.
extern "C" int octrt_fwd_tiled(
    const float* params, const int* counts, const float* tri_coef,
    const float* tri_attr, const float* sph_coef, const float* sph_attr,
    const float* tri_sh, const float* sph_sh, void* out, int* tiles,
    int height, int width, int ntx, int n_tiles, int k_tri, int k_sph,
    int sh_tri_stride, int sh_sph_stride, int n_lights, int shading,
    int shadows, int projective, int out_format, const int* run_if, int want,
    unsigned long long* stats, void* stream) {
  if (shading < SHADE_LEGACY || shading > SHADE_PHONG || n_tiles <= 0 ||
      n_lights < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const auto f4 = [](const float* p) { return reinterpret_cast<const float4*>(p); };
  const Args a{params, counts, f4(tri_coef), f4(tri_attr), f4(sph_coef),
               f4(sph_attr), f4(tri_sh), f4(sph_sh), out, height, width, ntx,
               n_tiles, k_tri, k_sph, sh_tri_stride, sh_sph_stride, n_lights,
               shadows, out_format == 0, run_if, want, stats};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(projective ? launch<true>(a, shading, tiles, s)
                          : launch<false>(a, shading, tiles, s));
}

extern "C" const char* octrt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
