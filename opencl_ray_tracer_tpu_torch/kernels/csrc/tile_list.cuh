// The list of a frame's non-empty tiles and the walk of the tiled forward
// kernels over it: B1/B2 (fwd_tiled.cu) and B4 (soft_tiled.cu). A 64 x 128
// tile is non-empty where its counts row holds a primary candidate
// (counts[t][0] + counts[t][1] > 0); the plain version of the list is
// kernels/fwd_tiled.py:_live_tiles.
//
// A frame's work is a list of units, one block a unit: first every group of
// a block's consecutive 8 x 4 patches of the non-empty tiles (the tiles in
// ascending order), then every empty tile, which one block fills with the
// background. Blocks are as many as fit on the card at once. Each block
// builds the list itself, in shared memory, from the counts (a few KB, read
// from L2): no list kernel runs before it and nothing waits for one. Block b
// takes the units b, b + grid, b + 2 grid, ..., so no block is launched for
// an empty tile and the costly units come first. The unit is block-uniform,
// and the list's two barriers are the only ones these helpers set. Each
// pixel of the frame is written once.

#pragma once

#include <cuda_runtime.h>

namespace octrt_tiles {

constexpr int TILE_H = 64;
constexpr int TILE_W = 128;
constexpr int TILE_PIX = TILE_H * TILE_W;
constexpr int PATCH_W = 8, PATCH_H = 4;
constexpr int PATCHES_X = TILE_W / PATCH_W;                   // 16
constexpr int TILE_PATCHES = PATCHES_X * (TILE_H / PATCH_H);  // 256

namespace {

// s_list[0, n_tiles) <- the non-empty tiles in ascending order, then the
// empty ones (in descending order), by the whole block; s_cnt holds one int
// a warp. Returns the number of non-empty tiles, in every thread.
__device__ int block_list(const int* counts, int stride, int n_tiles,
                          int* s_list, int* s_cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = (int)blockDim.x >> 5;
  int base = 0;  // non-empty tiles before this chunk
  for (int t0 = 0; t0 < n_tiles; t0 += blockDim.x) {
    const int t = t0 + (int)threadIdx.x;
    const bool live = t < n_tiles &&
                      __ldg(counts + (size_t)t * stride) +
                              __ldg(counts + (size_t)t * stride + 1) > 0;
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_cnt[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < nwarp; ++w) {
      const int c = s_cnt[w];
      total += c;
      before += w < warp ? c : 0;
    }
    const int pos = base + before + __popc(bal & ((1u << lane) - 1u));
    if (t < n_tiles) s_list[live ? pos : n_tiles - 1 - (t - pos)] = t;
    base += total;
    __syncthreads();  // s_cnt is read before the next chunk writes it, and
                      // the list is whole before anyone reads it
  }
  return base;
}

// tiles (2 + n_tiles ints) <- the block's list, as the wrappers hand it back:
// tiles[0] the number of non-empty tiles, tiles[1] zero (the layout of the
// backward's list of live patches: count, counter, entries), then the list.
__device__ void write_list(int* tiles, const int* s_list, int n_live,
                           int n_tiles) {
  if (threadIdx.x == 0) {
    tiles[0] = n_live;
    tiles[1] = 0;
  }
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) tiles[2 + i] = s_list[i];
}

// The frame's units as a block sees them: `groups` units for each of the
// n_live non-empty tiles, then one for each empty tile.
struct Units {
  const int* list;
  int n_live, n_groups, n_units, groups;

  __device__ Units(const int* list_, int n_live_, int n_tiles, int groups_)
      : list(list_), n_live(n_live_), groups(groups_) {
    n_groups = n_live * groups;
    n_units = n_groups + n_tiles - n_live;
  }
  __device__ bool is_group(int u) const { return u < n_groups; }
  // a group: its tile, and the first of its patches (row-major over the
  // tile's 16 x 16)
  __device__ int group_tile(int u) const { return list[u / groups]; }
  __device__ int group_patch(int u) const {
    return (u % groups) * (TILE_PATCHES / groups);
  }
  __device__ int empty_tile(int u) const { return list[n_live + u - n_groups]; }
};

// Tile `tile` of an (h, w) frame of T pixels <- v, by the whole block,
// consecutive threads on consecutive pixels of a row; the pixels beyond the
// frame's edge are not written.
template <class T>
__device__ void fill_tile(T* out, int tile, int ntx, int h, int w, T v) {
  const int ty = tile / ntx, tx = tile - ty * ntx;
  const int x0 = tx * TILE_W, y0 = ty * TILE_H;
  for (int i = threadIdx.x; i < TILE_PIX; i += blockDim.x) {
    const int x = x0 + (i & (TILE_W - 1)), y = y0 + i / TILE_W;
    if (x < w && y < h) out[(size_t)y * w + x] = v;
  }
}

// The float4s of a block's list in dynamic shared memory (the rows follow).
__host__ __device__ inline int list_float4s(int n_tiles) { return (n_tiles + 3) / 4; }

// The dynamic shared memory a block may take without asking for more.
constexpr size_t SMEM_DEFAULT_MAX = 48 * 1024;

// The blocks of `kernel` (`threads` a block, `smem` bytes of dynamic shared
// memory) that fit on the card this call runs on at once, at most `cap`,
// into `grid`.
template <class K>
cudaError_t resident_grid(K kernel, int threads, size_t smem, long long cap,
                          int& grid) {
  cudaError_t err;
  if (smem > SMEM_DEFAULT_MAX) {  // a list alone over 48 KB: > 12,288 tiles
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const long long resident = (long long)sms * per_sm;
  grid = (int)(cap < resident ? cap : resident);
  return cudaSuccess;
}

}  // namespace

}  // namespace octrt_tiles
