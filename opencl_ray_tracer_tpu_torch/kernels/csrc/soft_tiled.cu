// Tiled soft differentiable renderer for Hopper (sm_90a): forward (B4) and
// backward (B5), one thread per pixel.
//
// Replaces the TPU kernels opencl_ray_tracer_tpu/kernels/soft_tiled.py:
// _soft_tiled_fwd_pallas (1397) and _soft_tiled_bwd_pallas (1580). The
// plain PyTorch twin is opencl_ray_tracer_tpu_torch/kernels/soft_tiled.py:
// _soft_tiled_plain (forward) and its autograd (backward). The per-pixel
// math of both kernels is one copy, in soft_tiled.cuh.
//
// Forward, per 64x128 tile with primary candidates: each pixel streams its
// tile's triangle then sphere candidate rows (16 coefficients + 8 albedo
// floats) through an online softmin — running max m, normaliser z and the
// weighted sums (t, albedo, normals for aggregate shading; r, g, b for
// per-primitive shading) plus the background's log(1 - cov) sum — then
// shades: aggregate (phong, lambert + soft shadows, with a per-light
// occluder loop of sigmoid-gated log-visibility) or per-primitive (legacy,
// lambert). An empty tile writes (0, 0, 0, 255) and returns.
//
// Backward: recompute, then reverse, per pixel. Pass 1 re-runs the
// streaming pass and the occluder loops for the finals; the shade and
// geometry stages are reversed once; pass 2 walks the occluders and the
// candidates again with the final m held constant (the output does not
// depend on m, so its gradient is exactly zero) and forms each row's
// gradient. A row's gradient is summed over the block's 256 pixels (warp
// shuffles, then shared memory) and added to the per-tile gradient table
// with one atomicAdd per element and block; params/taus gradients go to
// per-tile rows the same way and the wrapper sums them over tiles.
// Atomics make the order of those sums vary from run to run: gradients
// agree with the twin to float32 rounding, not bit for bit.
//
// What bounds it on this card: FP32 ALU work and the special functions
// (expf/logf/sqrtf, about ten per candidate and pixel in the forward and
// three times that in the backward) — the tables are a few KB per tile and
// the image 16 B per pixel. A block covers two rows of one tile (32 blocks
// per tile), and all its threads walk the same candidate list. The forward
// stages that list through shared memory, 64 rows (6 KB) at a time, loaded
// by the whole block with coalesced reads; every thread then reads the same
// row (a broadcast). The backward, whose loops hold block reductions per
// row, reads its rows through the read-only cache (__ldg), as both kernels
// read the shadow tables. A compacted tile list and register tuning are
// later work.
//
// Numerics: built without --use_fast_math and with -fmad=false; sigmoid is
// 1/(1 + expf(-x)) so a null row's coverage is exactly 0; 1/sqrtf in place
// of rsqrt; explicit fmaf only where the twin rounds once (soft_tiled.cuh).

#include <cuda_runtime.h>

#include "soft_tiled.cuh"

using namespace octrt_soft;

namespace {

constexpr int BLOCK_ROWS = 2;
constexpr int THREADS = TILE_W * BLOCK_ROWS;  // 256
constexpr int GROUPS = TILE_H / BLOCK_ROWS;   // blocks per tile
constexpr int NWARP = THREADS / 32;
constexpr int RED_W = 64;                     // >= MAX_P
constexpr int STAGE_ROWS = 64;                // forward: rows per chunk
constexpr int STAGE_W = ROW + ALB;            // floats per staged row

struct Args {
  const float* params;
  const float* taus;
  const int* counts;      // (n_tiles, 2 + 2L)
  const float* tri;       // (n_tiles, k_tri, 16)
  const float* tri_alb;   // (n_tiles, k_tri, 8)
  const float* sph;       // (n_tiles, k_sph, 16)
  const float* sph_alb;   // (n_tiles, k_sph, 8)
  const float* tsh;       // (n_tiles | 1, L * sh_tri_stride, 16)
  const float* ssh;       // (n_tiles | 1, L * sh_sph_stride, 16)
  int height, width, ntx, k_tri, k_sph, sh_tri_stride, sh_sph_stride, nl;
  int shading, shadows, projective;
};

using BlockRed = BlockRedT<THREADS, RED_W>;

struct Pixel {
  int tile, xi, yi;
  bool inside;
  size_t pix;
};

__device__ __forceinline__ Pixel pixel_of(const Args& a) {
  Pixel p;
  p.tile = blockIdx.x / GROUPS;
  const int group = blockIdx.x - p.tile * GROUPS;
  const int ty = p.tile / a.ntx, tx = p.tile - ty * a.ntx;
  p.xi = tx * TILE_W + (int)(threadIdx.x % TILE_W);
  p.yi = ty * TILE_H + group * BLOCK_ROWS + (int)(threadIdx.x / TILE_W);
  p.inside = p.xi < a.width && p.yi < a.height;
  p.pix = (size_t)p.yi * a.width + p.xi;
  return p;
}

__device__ __forceinline__ bool tile_empty(const Args& a, int tile) {
  const int* cnt = a.counts + (size_t)tile * (2 + 2 * a.nl);
  return __ldg(cnt) + __ldg(cnt + 1) == 0;
}

__device__ __forceinline__ Tabs tabs_of(const Args& a, int tile) {
  return tile_tabs(a.tri, a.tri_alb, a.sph, a.sph_alb, a.tsh, a.ssh, a.counts,
                   tile, a.k_tri, a.k_sph, a.sh_tri_stride, a.sh_sph_stride,
                   a.nl, a.projective != 0);
}

template <bool PROJ>
__global__ void __launch_bounds__(THREADS) soft_fwd_kernel(Args a,
                                                           float4* out) {
  __shared__ float stage[STAGE_ROWS * STAGE_W];
  const Pixel p = pixel_of(a);
  if (tile_empty(a, p.tile)) {  // block-uniform: the background
    if (p.inside) out[p.pix] = make_float4(0.0f, 0.0f, 0.0f, 255.0f);
    return;
  }
  const Tabs T = tabs_of(a, p.tile);
  Ctx c;
  ctx_make<PROJ>(c, a.params, __ldg(a.taus), __ldg(a.taus + 1), (float)p.xi,
                 (float)p.yi, a.nl);
  const bool agg = is_aggregate(a.shading, a.shadows != 0);
  Fin f;
  fin_init(f);
  // The tile's candidate rows, STAGE_ROWS at a time, through shared memory:
  // every thread of the block (those outside the frame too) loads, then
  // every pixel of the frame streams the chunk. Row counts are the tile's,
  // so the loop and its barriers are block-uniform.
  for (int kind = 0; kind < 2; ++kind) {
    const int nrow = kind ? T.n_sph : T.n_tri;
    const float* rows = kind ? T.sph : T.tri;
    const float* albs = kind ? T.sph_alb : T.tri_alb;
    for (int base = 0; base < nrow; base += STAGE_ROWS) {
      const int n = min(STAGE_ROWS, nrow - base);
      __syncthreads();  // the previous chunk is consumed
      for (int i = threadIdx.x; i < n * STAGE_W; i += THREADS) {
        const int j = i / STAGE_W, q = i - j * STAGE_W;
        stage[i] = q < ROW ? __ldg(rows + (size_t)(base + j) * ROW + q)
                           : __ldg(albs + (size_t)(base + j) * ALB + q - ROW);
      }
      __syncthreads();
      if (p.inside) {
        for (int j = 0; j < n; ++j) {
          const float* r = stage + j * STAGE_W;
          stream_row<PROJ>(c, r, r + ROW, kind, agg, a.shading, f);
        }
      }
    }
  }
  if (!p.inside) return;
  float rgb[3];
  pixel_finish<PROJ>(c, T, f, a.shading, a.shadows != 0, rgb);
  out[p.pix] = make_float4(rgb[0], rgb[1], rgb[2], 255.0f);
}

template <bool PROJ>
__global__ void __launch_bounds__(THREADS) soft_bwd_kernel(
    Args a, const float4* g, DTabs D, float* d_par, float* d_tau) {
  __shared__ float smem[NWARP * RED_W];
  const Pixel p = pixel_of(a);
  if (tile_empty(a, p.tile)) return;  // block-uniform: zero gradient
  const Tabs T = tabs_of(a, p.tile);
  const float tau_d = __ldg(a.taus), tau_e = __ldg(a.taus + 1);
  Ctx c;
  ctx_make<PROJ>(c, a.params, tau_d, tau_e, (float)p.xi, (float)p.yi, a.nl);
  float gout[3] = {0.0f, 0.0f, 0.0f};
  if (p.inside) {
    const float4 gv = g[p.pix];
    gout[0] = gv.x;
    gout[1] = gv.y;
    gout[2] = gv.z;
  }
  const size_t t = (size_t)p.tile, sh_t = a.projective ? 0 : t;
  DTabs Dt;
  Dt.tri = D.tri + t * a.k_tri * ROW;
  Dt.tri_alb = D.tri_alb + t * a.k_tri * ALB;
  Dt.sph = D.sph + t * a.k_sph * ROW;
  Dt.sph_alb = D.sph_alb + t * a.k_sph * ALB;
  Dt.tsh = D.tsh + sh_t * a.nl * a.sh_tri_stride * ROW;
  Dt.ssh = D.ssh + sh_t * a.nl * a.sh_sph_stride * ROW;
  CtxGrad gc;
  zero_ctx_grad(gc);
  BlockRed red{smem};
  pixel_bwd<PROJ>(c, T, a.shading, a.shadows != 0, gout, p.inside, red, Dt,
                  gc);
  float dprm[MAX_P], dtau[2] = {0.0f, 0.0f};
  for (int i = 0; i < MAX_P; ++i) dprm[i] = 0.0f;
  if (p.inside) ctx_bwd<PROJ>(c, gc, tau_d, dprm, dtau);
  const int n_params = P_LIGHTS + a.nl * LSTRIDE;
  red.add<MAX_P>(d_par + t * n_params, dprm, n_params);
  red.add<2>(d_tau + t * 2, dtau);
}

bool bad_args(int n_tiles, int nl, int shading) {
  return n_tiles <= 0 || nl < 1 || nl > MAX_L || shading < SHADE_LEGACY ||
         shading > SHADE_PHONG;
}

}  // namespace

extern "C" int octrt_soft_tiled_fwd(
    const float* params, const float* taus, const int* counts,
    const float* tri, const float* tri_alb, const float* sph,
    const float* sph_alb, const float* tsh, const float* ssh, float* out,
    int height, int width, int ntx, int n_tiles, int k_tri, int k_sph,
    int sh_tri_stride, int sh_sph_stride, int nl, int shading, int shadows,
    int projective, void* stream) {
  if (bad_args(n_tiles, nl, shading)) return (int)cudaErrorInvalidValue;
  const Args a{params, taus, counts, tri, tri_alb, sph, sph_alb, tsh, ssh,
               height, width, ntx, k_tri, k_sph, sh_tri_stride, sh_sph_stride,
               nl, shading, shadows, projective};
  const dim3 grid(n_tiles * GROUPS), block(THREADS);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float4* o = reinterpret_cast<float4*>(out);
  if (projective) {
    soft_fwd_kernel<true><<<grid, block, 0, s>>>(a, o);
  } else {
    soft_fwd_kernel<false><<<grid, block, 0, s>>>(a, o);
  }
  return (int)cudaGetLastError();
}

extern "C" int octrt_soft_tiled_bwd(
    const float* params, const float* taus, const int* counts,
    const float* tri, const float* tri_alb, const float* sph,
    const float* sph_alb, const float* tsh, const float* ssh, const float* g,
    float* d_tri, float* d_tri_alb, float* d_sph, float* d_sph_alb,
    float* d_tsh, float* d_ssh, float* d_par, float* d_tau, int height,
    int width, int ntx, int n_tiles, int k_tri, int k_sph, int sh_tri_stride,
    int sh_sph_stride, int nl, int shading, int shadows, int projective,
    void* stream) {
  if (bad_args(n_tiles, nl, shading)) return (int)cudaErrorInvalidValue;
  const Args a{params, taus, counts, tri, tri_alb, sph, sph_alb, tsh, ssh,
               height, width, ntx, k_tri, k_sph, sh_tri_stride, sh_sph_stride,
               nl, shading, shadows, projective};
  const DTabs D{d_tri, d_tri_alb, d_sph, d_sph_alb, d_tsh, d_ssh};
  const dim3 grid(n_tiles * GROUPS), block(THREADS);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  if (projective) {
    soft_bwd_kernel<true><<<grid, block, 0, s>>>(a, g4, D, d_par, d_tau);
  } else {
    soft_bwd_kernel<false><<<grid, block, 0, s>>>(a, g4, D, d_par, d_tau);
  }
  return (int)cudaGetLastError();
}
