// Tiled soft differentiable renderer for Hopper (sm_90a): forward (B4) and
// backward (B5), a lane a pixel, a warp an 8 x 4 patch.
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
// lambert). An empty tile holds (0, 0, 0, 255).
//
// Backward: recompute, then reverse, per pixel (soft_tiled.cuh pixel_bwd).
// Pass 1 re-runs the streaming pass and the occluder loops for the finals;
// the shade and geometry stages are reversed once; pass 2 walks the
// occluders and the candidates again with the final m held constant (the
// output does not depend on m, so its gradient is exactly zero) and forms
// each row's gradient, which is summed over pixels into the per-tile
// gradient tables; params/taus gradients are summed into one row each.
// Atomics make the order of those sums vary from run to run: gradients
// agree with the twin to float32 rounding, not bit for bit.
//
// What bounds them on this card: FP32 ALU work and the special functions
// (expf/logf/sqrtf, about ten per candidate and pixel in the forward and
// three times that in the backward, none of them fast-math) - the tables
// are a few KB per tile and the image 16 B per pixel - but only for the
// pixels of the non-empty tiles; the forward's finish (geometry, shading,
// occluders) only for the pixels that something covers, the backward only
// for the pixels whose cotangent is not zero (every gradient is linear in
// it), plus one pass over the cotangents of the non-empty tiles. The
// forward writes every pixel of the frame once (16 B): on a sparse frame
// those bytes are its bound.
//
// The forward, what the design does about its bound (the shares: its
// device time on the 1080p train step's tables, phong + soft shadows, one
// NVIDIA H100 at 700 W, with the step switched off):
//   - the kernel's blocks, as many as fit on the card at once, each list
//     the non-empty tiles from the counts in shared memory (tile_list.cuh:
//     no list kernel before it) and take their turns of that list's units:
//     groups of 8 patches of 8 x 4 pixels, a warp a patch, of one non-empty
//     tile, then the empty tiles, which a block fills with the background.
//     No block is launched for an empty tile and no pixel is written twice;
//   - a warp walks its tile's rows on its own, read straight from the
//     tables as 128-bit loads that all its lanes ask for at once (a
//     broadcast; the block's 8 warps share its tile's rows in L1), with no
//     block barrier in any row loop (staging the rows in shared memory
//     first took 10% more);
//   - a pixel that nothing covers (1 - w_bg is exactly 0, so its value is
//     exactly 0) skips the geometry, the shading and the occluder walks,
//     and a warp none of whose pixels is covered skips the walks
//     altogether: on the 1080p train step 12% of the pixels of the
//     non-empty tiles are covered (18% more without it; 34% through a
//     pinhole camera);
//   - a build for exactly one light keeps the per-light arrays in
//     registers; two to four lights run the build that reads the count
//     (13% more without it);
//   - 64 registers, four blocks a multiprocessor (80 took 8% more, no cap
//     16% more).
//
// The backward, what the design does about its bound (the shares are of
// its device time on one NVIDIA H100 at 700 W, each step switched off in
// turn, on the 1080p train step's tables and on 1,300 primitives at
// 640x480):
//   - a first kernel, one block a non-empty tile, reads that tile's
//     cotangents once and writes the list of its 8 x 4 patches that hold a
//     non-zero one (count kept on the device); the pixel kernel's warps walk
//     nothing else, a warp a patch, so blocks of empty tiles are never
//     launched, an all-zero cotangent costs the list kernel and little
//     else, and a costly patch holds up one warp only. Blocks draw groups
//     of 8 consecutive patches from a counter where the list is longer than
//     the grid (3% on a dense 1080p cotangent, 11-21% at 1,300 primitives),
//     and take their own where not;
//   - inside a live patch a lane whose cotangent is zero computes nothing
//     and adds zeros;
//   - a row's gradient is summed over the warp only if some lane holds a
//     non-zero value (any-vote: 5-8%), with a transposing butterfly (24
//     shuffles a primary row, not 120: 10-19%), then one atomicAdd per
//     value from the lane that holds it, straight onto the tile's gradient
//     rows in device memory. No block barrier stands in any row loop.
//     Accumulators in shared memory were timed and lost (4-8% slower: the
//     vote leaves few enough atomics), as did staging a tile's rows in
//     shared memory (within 1%: the uniform 128-bit loads hit L1);
//   - a light's occluder reverse is skipped where d logvis is zero for the
//     whole warp;
//   - a build for exactly one light, the common scene, keeps the per-light
//     arrays in registers (13-22%; the local frame falls from 1,184 to 256
//     bytes); two to four lights run the build that reads the count;
//   - 128 registers a thread (two blocks a multiprocessor): 80 is 8% slower
//     on the train step's cotangent and 8-10% faster at 1,300 primitives,
//     255 slower everywhere;
//   - params/taus gradients stay in registers across a warp's patches and
//     go through one block reduction into one row.
//
// Numerics: built without --use_fast_math and with -fmad=false; sigmoid is
// 1/(1 + expf(-x)) so a null row's coverage is exactly 0; 1/sqrtf in place
// of rsqrt; explicit fmaf only where the twin rounds once (soft_tiled.cuh).

#include <cuda_runtime.h>

#include "soft_tiled.cuh"
#include "tile_list.cuh"

using namespace octrt_soft;

namespace {

namespace tl = octrt_tiles;

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int RED_W = 64;                     // >= MAX_P
// Blocks a multiprocessor that the compiler must leave registers for in
// the forward (64 registers).
constexpr int FWD_BLOCKS = 4;

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
  int height, width, ntx, n_tiles, k_tri, k_sph, sh_tri_stride, sh_sph_stride;
  int nl, shading, shadows, projective;
  const int* run_if;  // null: always run; else run only if *run_if == want
  int want;           // (lax.cond on the card: the untaken branch returns)
};

using BlockRed = BlockRedT<THREADS, RED_W>;

__device__ __forceinline__ bool tile_empty(const Args& a, int tile) {
  const int* cnt = a.counts + (size_t)tile * (2 + 2 * a.nl);
  return __ldg(cnt) + __ldg(cnt + 1) == 0;
}

__device__ __forceinline__ Tabs tabs_of(const Args& a, int tile) {
  return tile_tabs(a.tri, a.tri_alb, a.sph, a.sph_alb, a.tsh, a.ssh, a.counts,
                   tile, a.k_tri, a.k_sph, a.sh_tri_stride, a.sh_sph_stride,
                   a.nl, a.projective != 0);
}

// A tile is cut into 16 x 16 patches of 8 x 4 pixels, a lane a pixel.
using tl::PATCH_H;
using tl::PATCH_W;
using tl::PATCHES_X;
using tl::TILE_PATCHES;

// The pixel of `lane` in patch `patch` of tile `tile`.
__device__ __forceinline__ void patch_pixel(const Args& a, int tile, int patch,
                                            int lane, int& xi, int& yi) {
  const int ty = tile / a.ntx, tx = tile - ty * a.ntx;
  xi = tx * TILE_W + (patch % PATCHES_X) * PATCH_W + (lane & 7);
  yi = ty * TILE_H + (patch / PATCHES_X) * PATCH_H + (lane >> 3);
}

// ---- forward (B4) -----------------------------------------------------------
constexpr int FWD_GROUPS = TILE_PATCHES / NWARP;  // units of a non-empty tile

// NL: the number of lights, or 0 to read it at run time.
template <bool PROJ, int NL>
__global__ void __launch_bounds__(THREADS, FWD_BLOCKS) soft_fwd_kernel(
    Args a, int* tiles, float4* out) {
  if (a.run_if != nullptr && __ldg(a.run_if) != a.want) return;  // see Args::run_if
  extern __shared__ int s_list[];
  __shared__ int s_cnt[NWARP];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nl = NL ? NL : a.nl;
  const float tau_d = __ldg(a.taus), tau_e = __ldg(a.taus + 1);
  const bool agg = is_aggregate(a.shading, a.shadows != 0);
  const int n_live = tl::block_list(a.counts, 2 + 2 * a.nl, a.n_tiles, s_list, s_cnt);
  if (blockIdx.x == 0) tl::write_list(tiles, s_list, n_live, a.n_tiles);
  const tl::Units U(s_list, n_live, a.n_tiles, FWD_GROUPS);
  for (int unit = blockIdx.x; unit < U.n_units; unit += gridDim.x) {
    if (U.is_group(unit)) {
      const int tile = U.group_tile(unit);
      const Tabs T = tabs_of(a, tile);
      int xi, yi;
      patch_pixel(a, tile, U.group_patch(unit) + warp, lane, xi, yi);
      if (xi < a.width && yi < a.height) {
        Ctx c;
        ctx_make<PROJ>(c, a.params, tau_d, tau_e, (float)xi, (float)yi, nl);
        Fin f;
        stream_finals<PROJ>(c, T, agg, a.shading, f);
        float rgb[3];
        pixel_finish<PROJ>(c, T, f, a.shading, a.shadows != 0, rgb);
        out[(size_t)yi * a.width + xi] = make_float4(rgb[0], rgb[1], rgb[2], 255.0f);
      }
    } else {
      tl::fill_tile(out, U.empty_tile(unit), a.ntx, a.height, a.width,
                    make_float4(0.0f, 0.0f, 0.0f, 255.0f));
    }
  }
}

template <bool PROJ, int NL>
int launch_fwd(const Args& a, int* tiles, float4* out, cudaStream_t s) {
  auto kernel = soft_fwd_kernel<PROJ, NL>;
  const size_t smem = (size_t)tl::list_float4s(a.n_tiles) * sizeof(float4);
  int grid = 0;
  const cudaError_t err = tl::resident_grid(kernel, THREADS, smem,
                                            (long long)a.n_tiles * FWD_GROUPS, grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, s>>>(a, tiles, out);
  return (int)cudaGetLastError();
}

// ---- backward (B5) ----------------------------------------------------------
constexpr int LIVE_THREADS = 1024;  // the list kernel: one block a tile
constexpr int LIVE_PER_WARP = TILE_PATCHES / (LIVE_THREADS / 32);
constexpr unsigned FULL = 0xffffffffu;
// Blocks a multiprocessor that the compiler must leave registers for.
constexpr int BWD_BLOCKS = 2;

// The work list of the backward: live[0] the number of entries, live[1] the
// pixel kernel's counter (both zero at the start), live[2...] the entries,
// tile * 256 + patch for every patch of a non-empty tile that holds a pixel
// with a non-zero cotangent, in no order. One block lists one tile (an
// empty tile's returns at once), so a tile's entries are consecutive and the
// warps of one block of the pixel kernel mostly read the same rows.
__global__ void __launch_bounds__(LIVE_THREADS) live_patches_kernel(
    Args a, const float4* g, int* live) {
  __shared__ int s_cnt[32];
  __shared__ int s_base;
  const int tile = blockIdx.x;
  if (tile_empty(a, tile)) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned mask = 0;
#pragma unroll
  for (int q = 0; q < LIVE_PER_WARP; ++q) {
    int xi, yi;
    patch_pixel(a, tile, warp * LIVE_PER_WARP + q, lane, xi, yi);
    const bool nz = xi < a.width && yi < a.height &&
                    has_cotangent(__ldg(g + (size_t)yi * a.width + xi));
    if (__any_sync(FULL, nz)) mask |= 1u << q;
  }
  const int mine = __popc(mask);
  if (lane == 0) s_cnt[warp] = mine;
  __syncthreads();
  // every warp sums the 32 warps' counts: lane w holds warp w's
  const int cnt = s_cnt[lane];
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += up;
  }
  const int total = __shfl_sync(FULL, incl, 31);
  const int before = __shfl_sync(FULL, incl - cnt, warp);
  if (total == 0) return;  // the whole block
  if (threadIdx.x == 0) s_base = atomicAdd(live, total);
  __syncthreads();
  if (lane < LIVE_PER_WARP && (mask >> lane & 1u)) {
    live[2 + s_base + before + __popc(mask & ((1u << lane) - 1u))] =
        tile * TILE_PATCHES + warp * LIVE_PER_WARP + lane;
  }
}

// A warp's sums of row gradients, added to the tile's gradient rows.
struct WarpRed {
  int lane;
  __device__ __forceinline__ bool any(bool p) const {
    return __any_sync(FULL, p);
  }
  template <int N>
  __device__ __forceinline__ void add(float* dst, const float* v) const {
    warp_sum_add<N, N>(dst, v, lane);  // N is 8 or 16
  }
};

// NL: the number of lights, or 0 to read it at run time. With NL known every
// per-light array is indexed by constants and stays in registers.
template <bool PROJ, int NL>
__global__ void __launch_bounds__(THREADS, BWD_BLOCKS) soft_bwd_kernel(
    Args a, const float4* g, int* live, DTabs D, float* d_par, float* d_tau) {
  __shared__ float red_smem[NWARP * RED_W];
  __shared__ int s_grp[2];
  const int nl = NL ? NL : a.nl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float tau_d = __ldg(a.taus), tau_e = __ldg(a.taus + 1);
  float dprm[MAX_P], dtau[2] = {0.0f, 0.0f};
  for (int i = 0; i < MAX_P; ++i) dprm[i] = 0.0f;
  const WarpRed red{lane};

  // A block takes NWARP consecutive entries of the list at a time (nearly
  // always of one tile, so its warps read the same rows while they are in
  // the cache: 16-21% at 1,300 primitives against warps that draw alone),
  // a warp one entry: a patch, which it walks on its own, with no block
  // barrier in any row loop. Where the list is longer than the grid the
  // blocks draw their groups from a counter (patches differ in cost: a
  // covered pixel also reverses its occluders); where it is not, each block
  // has its own group and nobody waits for the counter.
  const int n_live = live[0];
  const int n_groups = (n_live + NWARP - 1) / NWARP;
  const bool drawn = n_groups > (int)gridDim.x;
  int grp = blockIdx.x;
  for (int it = 0;; ++it) {
    if (drawn) {  // two slots: a fast warp may already write the next draw
      if (threadIdx.x == 0) s_grp[it & 1] = atomicAdd(live + 1, 1);
      __syncthreads();
      grp = s_grp[it & 1];
    }
    if (grp >= n_groups) break;
    const int k = grp * NWARP + warp;
    grp += gridDim.x;
    if (k >= n_live) continue;  // the last group may be short
    const int entry = live[2 + k];
    const int tile = entry / TILE_PATCHES;
    const Tabs T = tabs_of(a, tile);
    const size_t t = (size_t)tile, sh_t = a.projective ? 0 : t;
    DTabs Dt;
    Dt.tri = D.tri + t * a.k_tri * ROW;
    Dt.tri_alb = D.tri_alb + t * a.k_tri * ALB;
    Dt.sph = D.sph + t * a.k_sph * ROW;
    Dt.sph_alb = D.sph_alb + t * a.k_sph * ALB;
    Dt.tsh = D.tsh + sh_t * a.nl * a.sh_tri_stride * ROW;
    Dt.ssh = D.ssh + sh_t * a.nl * a.sh_sph_stride * ROW;
    int xi, yi;
    patch_pixel(a, tile, entry % TILE_PATCHES, lane, xi, yi);
    float gout[3] = {0.0f, 0.0f, 0.0f};
    bool active = false;
    if (xi < a.width && yi < a.height) {
      const float4 gv = __ldg(g + (size_t)yi * a.width + xi);
      active = has_cotangent(gv);
      gout[0] = gv.x;
      gout[1] = gv.y;
      gout[2] = gv.z;
    }
    Ctx c;
    ctx_make<PROJ>(c, a.params, tau_d, tau_e, (float)xi, (float)yi, nl);
    CtxGrad gc;
    zero_ctx_grad(gc);
    pixel_bwd<PROJ>(c, T, a.shading, a.shadows != 0, gout, active, red, Dt,
                    gc);
    if (active) ctx_bwd<PROJ>(c, gc, tau_d, dprm, dtau);
  }

  // params / taus gradients: summed over the block, then added to one row
  BlockRed bred{red_smem};
  const int n_params = P_LIGHTS + nl * LSTRIDE;
  bred.add<MAX_P>(d_par, dprm, n_params);
  bred.add<2>(d_tau, dtau);
}

template <bool PROJ, int NL>
int launch_bwd(const Args& a, int n_tiles, const float4* g, int* live,
               const DTabs& D, float* d_par, float* d_tau, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(live, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  live_patches_kernel<<<n_tiles, LIVE_THREADS, 0, s>>>(a, g, live);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  auto kernel = soft_bwd_kernel<PROJ, NL>;
  // the blocks that fit at once on the card this call runs on
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const int resident = sms * per_sm;
  const long long want = (long long)n_tiles * (TILE_PATCHES / NWARP);
  const int grid = want < resident ? (int)want : resident;
  kernel<<<grid, THREADS, 0, s>>>(a, g, live, D, d_par, d_tau);
  return (int)cudaGetLastError();
}

bool bad_args(int n_tiles, int nl, int shading) {
  return n_tiles <= 0 || nl < 1 || nl > MAX_L || shading < SHADE_LEGACY ||
         shading > SHADE_PHONG;
}

}  // namespace

// tiles: 2 + n_tiles ints; it comes back as the list of tile_list.cuh
// (the number of non-empty tiles, a zero, the tiles). run_if: null, or an int
// on the card; then the kernel runs only if it equals want, and a skipped
// launch writes neither out nor tiles.
extern "C" int octrt_soft_tiled_fwd(
    const float* params, const float* taus, const int* counts,
    const float* tri, const float* tri_alb, const float* sph,
    const float* sph_alb, const float* tsh, const float* ssh, float* out,
    int* tiles, int height, int width, int ntx, int n_tiles, int k_tri,
    int k_sph, int sh_tri_stride, int sh_sph_stride, int nl, int shading,
    int shadows, int projective, const int* run_if, int want, void* stream) {
  if (bad_args(n_tiles, nl, shading)) return (int)cudaErrorInvalidValue;
  const Args a{params, taus, counts, tri, tri_alb, sph, sph_alb, tsh, ssh,
               height, width, ntx, n_tiles, k_tri, k_sph, sh_tri_stride,
               sh_sph_stride, nl, shading, shadows, projective, run_if, want};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float4* o = reinterpret_cast<float4*>(out);
  // one light is the common scene: the kernel is also built for exactly one
  if (projective) {
    return nl == 1 ? launch_fwd<true, 1>(a, tiles, o, s)
                   : launch_fwd<true, 0>(a, tiles, o, s);
  }
  return nl == 1 ? launch_fwd<false, 1>(a, tiles, o, s)
                 : launch_fwd<false, 0>(a, tiles, o, s);
}

// The six table gradients, d_par (21 + 7L) and d_tau (2) must be zero; live
// holds 2 + 256 * n_tiles ints and comes back as the count of entries, the
// pixel kernel's counter and the entries (see live_patches_kernel).
extern "C" int octrt_soft_tiled_bwd(
    const float* params, const float* taus, const int* counts,
    const float* tri, const float* tri_alb, const float* sph,
    const float* sph_alb, const float* tsh, const float* ssh, const float* g,
    float* d_tri, float* d_tri_alb, float* d_sph, float* d_sph_alb,
    float* d_tsh, float* d_ssh, float* d_par, float* d_tau, int* live,
    int height, int width, int ntx, int n_tiles, int k_tri, int k_sph,
    int sh_tri_stride, int sh_sph_stride, int nl, int shading, int shadows,
    int projective, void* stream) {
  if (bad_args(n_tiles, nl, shading)) return (int)cudaErrorInvalidValue;
  const Args a{params, taus, counts, tri, tri_alb, sph, sph_alb, tsh, ssh,
               height, width, ntx, n_tiles, k_tri, k_sph, sh_tri_stride,
               sh_sph_stride, nl, shading, shadows, projective};
  const DTabs D{d_tri, d_tri_alb, d_sph, d_sph_alb, d_tsh, d_ssh};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  // one light is the common scene: the kernel is also built for exactly one
  if (projective) {
    return nl == 1 ? launch_bwd<true, 1>(a, n_tiles, g4, live, D, d_par, d_tau, s)
                   : launch_bwd<true, 0>(a, n_tiles, g4, live, D, d_par, d_tau, s);
  }
  return nl == 1 ? launch_bwd<false, 1>(a, n_tiles, g4, live, D, d_par, d_tau, s)
                 : launch_bwd<false, 0>(a, n_tiles, g4, live, D, d_par, d_tau, s);
}
