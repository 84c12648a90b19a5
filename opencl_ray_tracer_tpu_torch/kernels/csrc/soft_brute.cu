// Brute soft differentiable renderer for Hopper (sm_90a): forward (B6) and
// backward (B7), one thread per pixel, every pixel against every primitive.
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
// (edge temperatures, r^2, guarded reciprocals) into scratch; the pixel
// kernels read those rows through the read-only cache (every thread of a
// warp reads the same address: a broadcast).
//
// Forward: each pixel streams every triangle, then every sphere, through
// the online softmin, then shades: per primitive (legacy, lambert) or on
// the aggregated hit (phong, lambert + soft shadows, with one occluder loop
// over all primitives per light).
//
// Backward: recompute, then reverse, per pixel (no residuals). The TPU
// kernel adds every grid step's gradients into revisited output blocks,
// which needs its sequential grid. Here a fixed grid of blocks walks the
// frame in groups of 256 pixels; a row's gradient is summed over a warp
// with shuffles and added to the block's own accumulators in shared memory
// (one shared atomicAdd per element and warp), and each block adds its
// accumulators to the scratch gradient rows once, at its end (one global
// atomicAdd per element and block). params/taus gradients stay in registers
// across the groups and go through one block reduction. A last small
// kernel maps the row gradients back onto the raw columns and tau_edge.
// Atomics make the order of the sums vary from run to run: gradients agree
// with the twin to float32 rounding, not bit for bit.
//
// What bounds it on this card: FP32 ALU and special-function work, pixels x
// primitives x (1 + lights) tests of ~100 operations in the forward and
// about three times that, plus the warp reductions, in the backward; the
// scene is a few KB and the image 16 B per pixel.
//
// Numerics: as soft_tiled.cu (no fast math, -fmad=false, 1/sqrtf).

#include <cuda_runtime.h>

#include "soft_tiled.cuh"

using namespace octrt_soft;

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int RED_W = 64;                     // >= MAX_P
constexpr int ACC_W = ROW + ALB;              // accumulator floats per primitive
// A block's accumulators must fit its shared memory: at most 2,400
// primitives (the wrapper's MAX_BWD_PRIMITIVES refuses more by name).
constexpr int MAX_SMEM = 227 * 1024;

struct Args {
  const float* params;
  const float* taus;
  const float* tri_geo;   // (14, tp)
  const float* tri_alb;   // (tp, 8)
  const float* sph_geo;   // (4, sp)
  const float* sph_alb;   // (sp, 8)
  int height, width, tp, sp, n_tris, n_spheres, nl, shading, shadows;
};

// scratch layout: n rows of ROW floats, then n albedo rows of ALB floats,
// triangles before spheres (the gradient scratch has the same layout)
__device__ __forceinline__ BTabs tabs_of(const Args& a, const float* rows) {
  const int n = a.n_tris + a.n_spheres;
  const float* albs = rows + (size_t)n * ROW;
  return BTabs{rows, albs, rows + (size_t)a.n_tris * ROW,
               albs + (size_t)a.n_tris * ALB, a.n_tris, a.n_spheres};
}

__global__ void rows_kernel(Args a, float* rows) {
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

template <bool NORM>
__global__ void __launch_bounds__(THREADS) soft_brute_fwd_kernel(
    Args a, const float* rows, float4* out) {
  const int flat = blockIdx.x * THREADS + (int)threadIdx.x;
  if (flat >= a.height * a.width) return;
  const int yi = flat / a.width, xi = flat - yi * a.width;
  Ctx c;
  brute_ctx_make<NORM>(c, a.params, __ldg(a.taus), __ldg(a.taus + 1), (float)xi,
                       (float)yi, a.nl);
  float rgb[3];
  brute_pixel_fwd(c, tabs_of(a, rows), a.shading, a.shadows != 0, rgb);
  out[flat] = make_float4(rgb[0], rgb[1], rgb[2], 255.0f);
}

// Sum N per-thread values over the warp, then one atomicAdd each into the
// block's shared accumulators. Every lane of a warp must call it.
struct WarpRed {
  template <int N>
  __device__ void add(float* dst, const float* v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = v[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_down_sync(0xffffffffu, s, off);
      }
      if (lane == 0 && s != 0.0f) atomicAdd(dst + i, s);
    }
  }
};

template <bool NORM>
__global__ void __launch_bounds__(THREADS) soft_brute_bwd_kernel(
    Args a, const float* rows, const float4* g, float* d_rows, float* d_par,
    float* d_tau) {
  extern __shared__ float smem[];  // n * ACC_W accumulators, then the reduce
  const int n = a.n_tris + a.n_spheres;
  float* acc = smem;
  float* red_smem = smem + (size_t)n * ACC_W;
  for (int i = threadIdx.x; i < n * ACC_W; i += THREADS) acc[i] = 0.0f;
  __syncthreads();

  const BTabs B = tabs_of(a, rows);
  float* acc_alb = acc + (size_t)n * ROW;
  const BDTabs D{acc, acc_alb, acc + (size_t)a.n_tris * ROW,
                 acc_alb + (size_t)a.n_tris * ALB};
  const float tau_d = __ldg(a.taus), tau_e = __ldg(a.taus + 1);
  float dprm[MAX_P], dtau[2] = {0.0f, 0.0f};
  for (int i = 0; i < MAX_P; ++i) dprm[i] = 0.0f;
  WarpRed red;

  const int n_pix = a.height * a.width;
  const int n_groups = (n_pix + THREADS - 1) / THREADS;
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int flat = grp * THREADS + (int)threadIdx.x;
    const bool active = flat < n_pix;
    const int pf = active ? flat : n_pix - 1;
    const int yi = pf / a.width, xi = pf - yi * a.width;
    Ctx c;
    brute_ctx_make<NORM>(c, a.params, tau_d, tau_e, (float)xi, (float)yi, a.nl);
    float gout[3] = {0.0f, 0.0f, 0.0f};
    if (active) {
      const float4 gv = g[flat];
      gout[0] = gv.x;
      gout[1] = gv.y;
      gout[2] = gv.z;
    }
    CtxGrad gc;
    zero_ctx_grad(gc);
    brute_pixel_bwd(c, B, a.shading, a.shadows != 0, gout, active, red, D, gc);
    if (active) brute_ctx_bwd<NORM>(c, gc, tau_d, dprm, dtau);
  }

  __syncthreads();
  for (int i = threadIdx.x; i < n * ACC_W; i += THREADS) {
    if (acc[i] != 0.0f) atomicAdd(d_rows + i, acc[i]);
  }
  BlockRedT<THREADS, RED_W> bred{red_smem};
  const int n_params = P_LIGHTS + a.nl * LSTRIDE;
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

template <bool NORM>
int launch_bwd(const Args& a, const float* rows, const float4* g, float* d_rows,
               float* d_par, float* d_tau, cudaStream_t s) {
  const int n = a.n_tris + a.n_spheres;
  const size_t smem = ((size_t)n * ACC_W + NWARP * RED_W) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = soft_brute_bwd_kernel<NORM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const int n_groups = (a.height * a.width + THREADS - 1) / THREADS;
  const int grid = n_groups < sms * per_sm ? n_groups : sms * per_sm;
  kernel<<<grid, THREADS, smem, s>>>(a, rows, g, d_rows, d_par, d_tau);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: (n_tris + n_spheres) * (16 + 8) floats.
extern "C" int octrt_soft_brute_fwd(
    const float* params, const float* taus, const float* tri_geo,
    const float* tri_alb, const float* sph_geo, const float* sph_alb,
    float* out, float* scratch, int height, int width, int tp, int sp,
    int n_tris, int n_spheres, int nl, int shading, int shadows,
    int normalize_dir, void* stream) {
  const Args a{params, taus, tri_geo, tri_alb, sph_geo, sph_alb, height, width,
               tp, sp, n_tris, n_spheres, nl, shading, shadows};
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int rc = launch_rows(a, scratch, s);
  if (rc != 0) return rc;
  const dim3 grid((height * width + THREADS - 1) / THREADS), block(THREADS);
  float4* o = reinterpret_cast<float4*>(out);
  if (normalize_dir) {
    soft_brute_fwd_kernel<true><<<grid, block, 0, s>>>(a, scratch, o);
  } else {
    soft_brute_fwd_kernel<false><<<grid, block, 0, s>>>(a, scratch, o);
  }
  return (int)cudaGetLastError();
}

// scratch as above; d_scratch has the same size and must be zero; the six
// gradient outputs must be zero too (padded columns are not written).
extern "C" int octrt_soft_brute_bwd(
    const float* params, const float* taus, const float* tri_geo,
    const float* tri_alb, const float* sph_geo, const float* sph_alb,
    const float* g, float* d_par, float* d_tau, float* d_tri_geo,
    float* d_tri_alb, float* d_sph_geo, float* d_sph_alb, float* scratch,
    float* d_scratch, int height, int width, int tp, int sp, int n_tris,
    int n_spheres, int nl, int shading, int shadows, int normalize_dir,
    void* stream) {
  const Args a{params, taus, tri_geo, tri_alb, sph_geo, sph_alb, height, width,
               tp, sp, n_tris, n_spheres, nl, shading, shadows};
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int rc = launch_rows(a, scratch, s);
  if (rc != 0) return rc;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  rc = normalize_dir
           ? launch_bwd<true>(a, scratch, g4, d_scratch, d_par, d_tau, s)
           : launch_bwd<false>(a, scratch, g4, d_scratch, d_par, d_tau, s);
  if (rc != 0) return rc;
  const int n = n_tris + n_spheres;
  if (n > 0) {
    rows_bwd_kernel<<<(n + 127) / 128, 128, 0, s>>>(
        a, d_scratch, d_tri_geo, d_tri_alb, d_sph_geo, d_sph_alb, d_tau);
  }
  return (int)cudaGetLastError();
}
