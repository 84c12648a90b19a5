// Brute soft differentiable renderer for Hopper (sm_90a): forward (B6) and
// backward (B7), every pixel against every primitive, no binning, no cull.
//
// Replaces the TPU kernels opencl_ray_tracer_tpu/kernels/soft.py:
// _soft_pallas_fwd (494, body _tile_soft_math) and _soft_pallas_bwd_arrays
// (543). The plain PyTorch twin is
// opencl_ray_tracer_tpu_torch/kernels/soft.py: _soft_brute_plain (forward)
// and its autograd (backward). The per-pixel math of both kernels is in
// soft_tiled.cuh, shared with the tiled soft kernels: the streaming softmin,
// the shading, the soft-shadow occluder tests and every hand-written
// reverse; the brute additions there are the primary tests for a per-pixel
// ray on the primitives' own geometry.
//
// Operands are the raw scene arrays (tri_geo (14, Tp), tri_alb (Tp, 8),
// sph_geo (4, Sp), sph_alb (Sp, 8)), and the gradients come back in that
// layout. A first small kernel derives one 16-float row per real primitive
// (edge temperatures, r^2, guarded reciprocals) into scratch, and a last
// one maps the row gradients back onto the raw columns and tau_edge.
//
// Both pixel kernels give a warp an 8 x 4 patch of pixels, so that the
// pixels a warp shares a fate with (covered or not, cotangent or not) are
// neighbours in both directions, and read each row as float4s that every
// lane of the warp asks for at once (a broadcast).
//
// Forward (B6), what bounds it: FP32 ALU and special-function work, pixels
// x primitives soft tests (three sigmoids, a log, an exp and a log1p each,
// none of them fast-math) for the streaming softmin; the scene is a few KB
// and the image 16 B a pixel. What the design does: a block of 8 patches
// stages the rows through shared memory once (128 primitives at a time for
// larger scenes), so a test costs 4-6 shared float4 reads, not 24 scalar
// loads; and a pixel that nothing covers (1 - w_bg is exactly 0, so its
// value is exactly 0) skips the finish, the shading and the occluder walk
// of every light, which is all but the primary tests on a sparse frame. No
// primitive is culled for any pixel: the softmin sees every coverage.
// Both kernels are also built for exactly one light, the common scene, which
// keeps the per-light arrays in registers (B7's local frame falls from
// 1,024 to 280 bytes).
//
// Backward (B7): recompute, then reverse, per pixel (no residuals). What
// bounds it: the same arithmetic about four times over (a recompute and the
// reverse of every test), but only for pixels whose cotangent is not zero,
// plus one pass over the cotangents (16 B a pixel); and the sums over
// pixels, which the TPU kernel takes by revisiting output blocks on its
// sequential grid. What the design does:
//   - a first kernel reads the cotangents once and writes the list of
//     patches that hold a non-zero one (count kept on the device); the
//     pixel kernel's warps draw from that list through a counter (or, when
//     it is shorter than the grid, take one entry each), each on its own
//     with no block barrier, so no warp spends time on a patch that needs
//     nothing and a costly patch holds up one warp only;
//   - inside a live patch a lane whose cotangent is zero computes nothing
//     and adds zeros (every gradient is linear in the cotangent);
//   - a primitive's row gradient is summed over the warp only if some lane
//     holds a non-zero value (a primitive whose coverage underflowed over
//     the whole patch gives exact zeros), with a transposing butterfly
//     (soft_tiled.cuh: 16 values in 16 shuffles, not 80), then one atomicAdd per value from
//     the lane that holds it, straight onto the scratch gradient rows in
//     device memory. With the vote these atomics are few enough that
//     accumulators in shared memory buy nothing (timed: no gain on a sparse
//     or a dense cotangent, a loss at 1,300 primitives), and without them
//     any number of primitives works, as on the TPU, and the block keeps
//     its shared memory;
//   - a light's occluder reverse is skipped where d logvis is zero for the
//     whole warp (every pixel that nothing covers);
//   - params/taus gradients stay in registers across a warp's patches and
//     go through one block reduction.
// Atomics make the order of the sums vary from run to run: gradients agree
// with the twin to float32 rounding, not bit for bit.
//
// Numerics: as soft_tiled.cu (no fast math, -fmad=false, 1/sqrtf).

#include <cuda_runtime.h>

#include "soft_tiled.cuh"

using namespace octrt_soft;

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int RED_W = 64;                     // >= MAX_P
constexpr int CHUNK = 128;                    // rows the forward stages at a time
constexpr int LIVE_PER_WARP = 8;              // patches a warp of the list kernel tests
constexpr unsigned FULL = 0xffffffffu;
// Blocks a multiprocessor that the compiler must leave registers for: the
// forward runs fastest at 64 registers, the backward at 128 (at 80 it
// spills: slower on all but the dense headline frame).
constexpr int FWD_BLOCKS = 4;
constexpr int BWD_BLOCKS = 2;

struct Args {
  const float* params;
  const float* taus;
  const float* tri_geo;   // (14, tp)
  const float* tri_alb;   // (tp, 8)
  const float* sph_geo;   // (4, sp)
  const float* sph_alb;   // (sp, 8)
  int height, width, tp, sp, n_tris, n_spheres, nl, shading, shadows;
  const int* run_if;  // null: always run; else run only if *run_if == want
  int want;           // (lax.cond on the card: the untaken branch returns)
};

// scratch layout: n rows of ROW floats, then n albedo rows of ALB floats,
// triangles before spheres (the gradient scratch has the same layout)
__global__ void rows_kernel(Args a, float* rows) {
  if (a.run_if != nullptr && __ldg(a.run_if) != a.want) return;  // see Args::run_if
  const int n = a.n_tris + a.n_spheres;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float* r = rows + (size_t)i * ROW;
  float* alb = rows + (size_t)n * ROW + (size_t)i * ALB;
  if (i < a.n_tris) {
    tri_row_make(a.tri_geo, a.tp, i, __ldg(a.taus + 1), r);
    for (int q = 0; q < ALB; ++q) alb[q] = __ldg(a.tri_alb + (size_t)i * ALB + q);
  } else {
    const int j = i - a.n_tris;
    sph_row_make(a.sph_geo, a.sp, j, r);
    for (int q = 0; q < ALB; ++q) alb[q] = __ldg(a.sph_alb + (size_t)j * ALB + q);
  }
}

// A frame cut into patches of 8 x 4 pixels, one lane each, row-major.
struct Patches {
  int npx, count;
  __host__ __device__ Patches(int height, int width)
      : npx((width + 7) >> 3), count(npx * ((height + 3) >> 2)) {}
  // the pixel of `lane` in patch (px, py)
  __device__ void pixel(int px, int py, int lane, int& xi, int& yi) const {
    xi = (px << 3) + (lane & 7);
    yi = (py << 2) + (lane >> 3);
  }
};

__device__ __forceinline__ void unpack4(const float4 v, float* dst) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// The rows straight from the scratch in device memory, read by every lane
// of a warp at once; the warp walks alone.
struct GlobalRows {
  const float4* rows;  // (n, ROW / 4)
  const float4* albs;  // (n, ALB / 4)
  int n_tri, n;

  template <bool WITH_ALB, bool SPH, class F>
  __device__ __forceinline__ void one(int i, F& f) const {
    float r[ROW], alb[ALB];
#pragma unroll
    for (int k = 0; k < ROW / 4; ++k) unpack4(__ldg(rows + (size_t)i * (ROW / 4) + k), r + 4 * k);
    if (WITH_ALB) {
#pragma unroll
      for (int k = 0; k < ALB / 4; ++k) unpack4(__ldg(albs + (size_t)i * (ALB / 4) + k), alb + 4 * k);
    }
    f(i, Kind<SPH>{}, r, alb);
  }
  template <bool WITH_ALB, class F>
  __device__ __forceinline__ void for_each(F f) const {
    for (int i = 0; i < n_tri; ++i) one<WITH_ALB, false>(i, f);
    for (int i = n_tri; i < n; ++i) one<WITH_ALB, true>(i, f);
  }
  __device__ __forceinline__ bool any(bool p) const { return __any_sync(FULL, p); }
};

// The rows staged through a block's shared memory, CHUNK primitives at a
// time; the block walks together. A scene of at most CHUNK primitives is
// staged once, and then its warps walk (and vote) each on their own.
struct StagedRows {
  const float4* rows;
  const float4* albs;
  int n_tri, n;
  float4* s_rows;  // [CHUNK * ROW / 4]
  float4* s_albs;  // [CHUNK * ALB / 4]
  int staged;      // first primitive of the staged chunk, -1: none

  __device__ __forceinline__ void stage(int base, int m) {
    if (staged == base) return;
    __syncthreads();
    for (int q = threadIdx.x; q < m * (ROW / 4); q += THREADS) {
      s_rows[q] = __ldg(rows + (size_t)base * (ROW / 4) + q);
    }
    for (int q = threadIdx.x; q < m * (ALB / 4); q += THREADS) {
      s_albs[q] = __ldg(albs + (size_t)base * (ALB / 4) + q);
    }
    __syncthreads();
    staged = base;
  }
  template <bool WITH_ALB, bool SPH, class F>
  __device__ __forceinline__ void one(int i, int j, F& f) const {
    float r[ROW], alb[ALB];
#pragma unroll
    for (int k = 0; k < ROW / 4; ++k) unpack4(s_rows[j * (ROW / 4) + k], r + 4 * k);
    if (WITH_ALB) {
#pragma unroll
      for (int k = 0; k < ALB / 4; ++k) unpack4(s_albs[j * (ALB / 4) + k], alb + 4 * k);
    }
    f(i, Kind<SPH>{}, r, alb);
  }
  template <bool WITH_ALB, class F>
  __device__ __forceinline__ void for_each(F f) {
    for (int base = 0; base < n; base += CHUNK) {
      const int end = min(base + CHUNK, n);
      stage(base, end - base);
      for (int i = base; i < min(end, n_tri); ++i) one<WITH_ALB, false>(i, i - base, f);
      for (int i = max(base, n_tri); i < end; ++i) one<WITH_ALB, true>(i, i - base, f);
    }
  }
  __device__ __forceinline__ bool any(bool p) const {
    return n <= CHUNK ? __any_sync(FULL, p) : __syncthreads_or(p) != 0;
  }
};

// NL: the number of lights, or 0 to read it at run time. With NL known every
// per-light array is indexed by constants and stays in registers.
template <bool NORM, int NL>
__global__ void __launch_bounds__(THREADS, FWD_BLOCKS) soft_brute_fwd_kernel(
    Args a, const float* rows, float4* out) {
  if (a.run_if != nullptr && __ldg(a.run_if) != a.want) return;  // see Args::run_if
  __shared__ float4 s_rows[CHUNK * ROW / 4];
  __shared__ float4 s_albs[CHUNK * ALB / 4];
  const Patches P(a.height, a.width);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a block: 4 x 2 patches
  int xi, yi;
  P.pixel(blockIdx.x * 4 + (warp & 3), blockIdx.y * 2 + (warp >> 2), lane, xi, yi);
  const bool inside = xi < a.width && yi < a.height;
  Ctx c;
  brute_ctx_make<NORM>(c, a.params, __ldg(a.taus), __ldg(a.taus + 1), (float)xi,
                       (float)yi, NL ? NL : a.nl);
  const int n = a.n_tris + a.n_spheres;
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  StagedRows B{r4, r4 + (size_t)n * (ROW / 4), a.n_tris, n, s_rows, s_albs, -1};
  float rgb[3];
  brute_pixel_fwd(c, B, a.shading, a.shadows != 0, inside, rgb);
  if (inside) out[(size_t)yi * a.width + xi] = make_float4(rgb[0], rgb[1], rgb[2], 255.0f);
}

// live[0]: the number of patches that hold a non-zero cotangent; live[2...]:
// those patches, in no order. live[0] must be zero at the start (live[1] is
// the pixel kernel's counter).
__global__ void __launch_bounds__(THREADS) live_patches_kernel(
    const float4* g, int height, int width, int* live) {
  const Patches P(height, width);
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * NWARP + (threadIdx.x >> 5)) * LIVE_PER_WARP;
  unsigned mask = 0;
  for (int q = 0; q < LIVE_PER_WARP; ++q) {
    const int patch = first + q;
    if (patch >= P.count) break;
    int xi, yi;
    P.pixel(patch % P.npx, patch / P.npx, lane, xi, yi);
    const bool nz = xi < width && yi < height &&
                    has_cotangent(__ldg(g + (size_t)yi * width + xi));
    if (__any_sync(FULL, nz)) mask |= 1u << q;
  }
  if (mask == 0) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(live, __popc(mask));
  base = __shfl_sync(FULL, base, 0);
  if (lane < LIVE_PER_WARP && (mask >> lane & 1u)) {
    live[2 + base + __popc(mask & ((1u << lane) - 1u))] = first + lane;
  }
}

// The sums of a patch's row gradients over its warp (warp_sum_add, shared
// with the tiled backward), added to the gradient rows in device memory.
// Every lane of the warp must call.
struct PatchRed {
  float* d_rows;  // the scratch layout for n primitives
  int n, lane;

  template <int N>
  __device__ __forceinline__ bool none(const float* v) const {
    return !__any_sync(FULL, nonzero<N>(v));
  }

  __device__ __forceinline__ void prim(int i, const float* g) const {
    if (none<ROW + 3>(g)) return;
    warp_sum_add<ROW, 16>(d_rows + (size_t)i * ROW, g, lane);
    warp_sum_add<3, 4>(d_rows + (size_t)n * ROW + (size_t)i * ALB, g + ROW, lane);
  }
  __device__ __forceinline__ void occ(int i, const float* gr) const {
    if (none<12>(gr)) return;
    warp_sum_add<12, 16>(d_rows + (size_t)i * ROW, gr, lane);
  }
};

template <bool NORM, int NL>
__global__ void __launch_bounds__(THREADS, BWD_BLOCKS) soft_brute_bwd_kernel(
    Args a, const float* rows, const float4* g, int* live, float* d_rows,
    float* d_par, float* d_tau) {
  __shared__ float red_smem[NWARP * RED_W];
  const int n = a.n_tris + a.n_spheres;
  const int nl = NL ? NL : a.nl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Patches P(a.height, a.width);
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  GlobalRows B{r4, r4 + (size_t)n * (ROW / 4), a.n_tris, n};
  PatchRed red{d_rows, n, lane};
  const float tau_d = __ldg(a.taus), tau_e = __ldg(a.taus + 1);
  float dprm[MAX_P], dtau[2] = {0.0f, 0.0f};
  for (int i = 0; i < MAX_P; ++i) dprm[i] = 0.0f;

  // Each warp draws its next live patch from a counter: the patches differ
  // in cost (a covered pixel also reverses its occluders). Where the list
  // is so short that no warp gets a second patch the warps of all blocks
  // take their own entries instead, interleaved so that the list spreads
  // over every block, and nobody waits for the counter.
  const int n_work = live[0];
  const int stride = gridDim.x * NWARP;
  const bool drawn = n_work > stride;
  int k = warp * gridDim.x + blockIdx.x;
  for (;;) {
    if (drawn) {
      if (lane == 0) k = atomicAdd(live + 1, 1);
      k = __shfl_sync(FULL, k, 0);
    }
    if (k >= n_work) break;
    const int patch = live[2 + k];
    k += stride;
    int xi, yi;
    P.pixel(patch % P.npx, patch / P.npx, lane, xi, yi);
    float gout[3] = {0.0f, 0.0f, 0.0f};
    bool active = false;
    if (xi < a.width && yi < a.height) {
      const float4 gv = __ldg(g + (size_t)yi * a.width + xi);
      active = has_cotangent(gv);
      gout[0] = gv.x;
      gout[1] = gv.y;
      gout[2] = gv.z;
    }
    if (!__any_sync(FULL, active)) continue;
    Ctx c;
    brute_ctx_make<NORM>(c, a.params, tau_d, tau_e, (float)xi, (float)yi, nl);
    CtxGrad gc;
    zero_ctx_grad(gc);
    brute_pixel_bwd(c, B, a.shading, a.shadows != 0, gout, active, red, gc);
    if (active) brute_ctx_bwd<NORM>(c, gc, tau_d, dprm, dtau);
  }

  BlockRedT<THREADS, RED_W> bred{red_smem};
  const int n_params = P_LIGHTS + nl * LSTRIDE;
  bred.add<MAX_P>(d_par, dprm, n_params);
  bred.add<2>(d_tau, dtau);
}

// Row gradients (scratch layout) -> gradients of the raw operand columns;
// the rows' share of d tau_edge is added to d_tau[1].
__global__ void rows_bwd_kernel(Args a, const float* d_rows, float* d_tri_geo,
                                float* d_tri_alb, float* d_sph_geo,
                                float* d_sph_alb, float* d_tau) {
  const int n = a.n_tris + a.n_spheres;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* gr = d_rows + (size_t)i * ROW;
  const float* galb = d_rows + (size_t)n * ROW + (size_t)i * ALB;
  if (i < a.n_tris) {
    float dcol[14];
    const float gte = tri_row_bwd(a.tri_geo, a.tp, i, __ldg(a.taus + 1), gr, dcol);
    for (int q = 0; q < 14; ++q) d_tri_geo[(size_t)q * a.tp + i] = dcol[q];
    for (int q = 0; q < 3; ++q) d_tri_alb[(size_t)i * ALB + q] = galb[q];
    if (gte != 0.0f) atomicAdd(d_tau + 1, gte);
  } else {
    const int j = i - a.n_tris;
    float dcol[4];
    sph_row_bwd(a.sph_geo, a.sp, j, gr, dcol);
    for (int q = 0; q < 4; ++q) d_sph_geo[(size_t)q * a.sp + j] = dcol[q];
    for (int q = 0; q < 3; ++q) d_sph_alb[(size_t)j * ALB + q] = galb[q];
  }
}

bool bad_args(const Args& a) {
  return a.height <= 0 || a.width <= 0 || a.nl < 1 || a.nl > MAX_L ||
         a.shading < SHADE_LEGACY || a.shading > SHADE_PHONG || a.n_tris < 0 ||
         a.n_tris > a.tp || a.n_spheres < 0 || a.n_spheres > a.sp;
}

int launch_rows(const Args& a, float* rows, cudaStream_t s) {
  const int n = a.n_tris + a.n_spheres;
  if (n > 0) rows_kernel<<<(n + 127) / 128, 128, 0, s>>>(a, rows);
  return (int)cudaGetLastError();
}

template <bool NORM, int NL>
int launch_bwd(const Args& a, const float* rows, const float4* g, int* live,
               float* d_rows, float* d_par, float* d_tau, cudaStream_t s) {
  const Patches P(a.height, a.width);
  cudaError_t err = cudaMemsetAsync(live, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int per_block = NWARP * LIVE_PER_WARP;
  live_patches_kernel<<<(P.count + per_block - 1) / per_block, THREADS, 0, s>>>(
      g, a.height, a.width, live);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  auto kernel = soft_brute_bwd_kernel<NORM, NL>;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const int want = (P.count + NWARP - 1) / NWARP;
  const int grid = want < sms * per_sm ? want : sms * per_sm;
  kernel<<<grid, THREADS, 0, s>>>(a, rows, g, live, d_rows, d_par, d_tau);
  return (int)cudaGetLastError();
}

template <bool NORM, int NL>
int launch_fwd(const Args& a, const float* rows, float4* out, cudaStream_t s) {
  const dim3 grid((a.width + 31) / 32, (a.height + 7) / 8);  // 4 x 2 patches
  soft_brute_fwd_kernel<NORM, NL><<<grid, THREADS, 0, s>>>(a, rows, out);
  return (int)cudaGetLastError();
}

// One light is the common scene: the kernels are also built for exactly one.
#define OCTRT_DISPATCH(fn, norm, one_light, ...)                          \
  ((norm) ? ((one_light) ? fn<true, 1>(__VA_ARGS__) : fn<true, 0>(__VA_ARGS__)) \
          : ((one_light) ? fn<false, 1>(__VA_ARGS__) : fn<false, 0>(__VA_ARGS__)))

}  // namespace

// scratch: (n_tris + n_spheres) * (16 + 8) floats. run_if: null, or an int
// on the card; then both kernels run only if it equals want, and a skipped
// launch writes neither out nor scratch.
extern "C" int octrt_soft_brute_fwd(
    const float* params, const float* taus, const float* tri_geo,
    const float* tri_alb, const float* sph_geo, const float* sph_alb,
    float* out, float* scratch, int height, int width, int tp, int sp,
    int n_tris, int n_spheres, int nl, int shading, int shadows,
    int normalize_dir, const int* run_if, int want, void* stream) {
  const Args a{params, taus, tri_geo, tri_alb, sph_geo, sph_alb, height, width,
               tp, sp, n_tris, n_spheres, nl, shading, shadows, run_if, want};
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int rc = launch_rows(a, scratch, s);
  if (rc != 0) return rc;
  return OCTRT_DISPATCH(launch_fwd, normalize_dir != 0, nl == 1, a, scratch,
                        reinterpret_cast<float4*>(out), s);
}

// scratch as above; d_scratch has the same size and must be zero; the six
// gradient outputs must be zero too (padded columns are not written); live
// holds 2 + ceil(width / 8) * ceil(height / 4) ints and comes back as the
// count of live patches, the pixel kernel's counter and the live patches.
extern "C" int octrt_soft_brute_bwd(
    const float* params, const float* taus, const float* tri_geo,
    const float* tri_alb, const float* sph_geo, const float* sph_alb,
    const float* g, float* d_par, float* d_tau, float* d_tri_geo,
    float* d_tri_alb, float* d_sph_geo, float* d_sph_alb, float* scratch,
    float* d_scratch, int* live, int height, int width, int tp, int sp,
    int n_tris, int n_spheres, int nl, int shading, int shadows,
    int normalize_dir, void* stream) {
  const Args a{params, taus, tri_geo, tri_alb, sph_geo, sph_alb, height, width,
               tp, sp, n_tris, n_spheres, nl, shading, shadows};
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int rc = launch_rows(a, scratch, s);
  if (rc != 0) return rc;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  rc = OCTRT_DISPATCH(launch_bwd, normalize_dir != 0, nl == 1, a, scratch, g4,
                      live, d_scratch, d_par, d_tau, s);
  if (rc != 0) return rc;
  const int n = n_tris + n_spheres;
  if (n > 0) {
    rows_bwd_kernel<<<(n + 127) / 128, 128, 0, s>>>(
        a, d_scratch, d_tri_geo, d_tri_alb, d_sph_geo, d_sph_alb, d_tau);
  }
  return (int)cudaGetLastError();
}
