// Order-preserving stream compaction of the fused pass (K1).
//
// A stream of (key, w, r, g, b) rows is cut into tiles of COMPACT_TILE rows.
// The producer writes each tile's live count (key != INVALID); one block
// scans the tile counts into exclusive offsets and the total; the scatter
// kernel then moves each live row to offset[tile] + its rank inside the tile
// and fills [total, n) with (INVALID, 0).  Input order is kept exactly: MAX
// ties downstream depend on it, so no atomics-based append is used.
//
// Several streams of one length n compact in the same two launches (the
// batched fused pass): stream p's rows start at p * n in every array, its
// tile counts and offsets at p * tiles, its total at total[p]; the scan
// runs one block a stream, the scatter a (tiles, streams) grid.
#pragma once

#include <cuda_runtime.h>

#define O2V_INV 2147483647

namespace {

constexpr int COMPACT_TILE = 256;
constexpr int SCAN_THREADS = 1024;

// Exclusive rank of `live` among the threads of a COMPACT_TILE block; the
// block's live total lands in `total`.  Every thread of the block must call.
__device__ __forceinline__ int block_rank(bool live, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  const int rank = __popc(mask & ((1u << lane) - 1u));
  if (lane == 0) s_warp[warp] = __popc(mask);
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int i = 0; i < COMPACT_TILE / 32; ++i) {
      const int c = s_warp[i];
      s_warp[i] = acc;
      acc += c;
    }
    s_warp[COMPACT_TILE / 32] = acc;
  }
  __syncthreads();
  total = s_warp[COMPACT_TILE / 32];
  return s_warp[warp] + rank;
}

// One block of SCAN_THREADS a stream (blockIdx.x) walks its n tile counts
// in chunks, carrying the running base between chunks.
__global__ void __launch_bounds__(SCAN_THREADS)
exclusive_scan_kernel(const int* __restrict__ counts, int* __restrict__ offsets,
                      int* __restrict__ total_out, int n) {
  const size_t stream_off = static_cast<size_t>(blockIdx.x) * n;
  counts += stream_off;
  offsets += stream_off;
  total_out += blockIdx.x;
  __shared__ int s_warp[SCAN_THREADS / 32];
  __shared__ int s_base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_base = 0;
  __syncthreads();
  for (int start = 0; start < n; start += SCAN_THREADS) {
    const int i = start + threadIdx.x;
    const int v = i < n ? counts[i] : 0;
    int x = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = s_warp[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += y;
      }
      s_warp[lane] = s;
    }
    __syncthreads();
    const int base = s_base;
    const int warp_excl = warp > 0 ? s_warp[warp - 1] : 0;
    if (i < n) offsets[i] = base + warp_excl + x - v;
    __syncthreads();
    if (threadIdx.x == SCAN_THREADS - 1) s_base = base + warp_excl + x;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total_out = s_base;
}

__global__ void __launch_bounds__(COMPACT_TILE)
scatter_kernel(const int* __restrict__ keys, const float* __restrict__ w,
               const float* __restrict__ r, const float* __restrict__ g,
               const float* __restrict__ b, int* __restrict__ ok,
               float* __restrict__ ow, float* __restrict__ orr,
               float* __restrict__ og, float* __restrict__ ob,
               const int* __restrict__ tile_offsets,
               const int* __restrict__ total_ptr, int n) {
  // stream blockIdx.y
  const size_t row0 = static_cast<size_t>(blockIdx.y) * n;
  keys += row0;
  w += row0;
  r += row0;
  g += row0;
  b += row0;
  ok += row0;
  ow += row0;
  orr += row0;
  og += row0;
  ob += row0;
  tile_offsets += static_cast<size_t>(blockIdx.y) * gridDim.x;
  total_ptr += blockIdx.y;
  __shared__ int s_warp[COMPACT_TILE / 32 + 1];
  const int i = blockIdx.x * COMPACT_TILE + threadIdx.x;
  const int k = i < n ? keys[i] : O2V_INV;
  const bool live = k != O2V_INV;
  int tile_total;
  const int rank = block_rank(live, s_warp, tile_total);
  if (live) {
    const int dst = tile_offsets[blockIdx.x] + rank;
    ok[dst] = k;
    ow[dst] = w[i];
    orr[dst] = r[i];
    og[dst] = g[i];
    ob[dst] = b[i];
  }
  if (i < n && i >= *total_ptr) {
    ok[i] = O2V_INV;
    ow[i] = 0.0f;
    orr[i] = 0.0f;
    og[i] = 0.0f;
    ob[i] = 0.0f;
  }
}

// Scan the tile counts and scatter `n_streams` streams of n rows; the
// producer must already have written each tile's live count.
inline cudaError_t compact_from_tile_counts(
    const int* keys, const float* w, const float* r, const float* g,
    const float* b, int* ok, float* ow, float* orr, float* og, float* ob,
    int* count_out, const int* tile_counts, int* tile_offsets, int n,
    int n_streams, cudaStream_t stream) {
  const int n_tiles = (n + COMPACT_TILE - 1) / COMPACT_TILE;
  exclusive_scan_kernel<<<n_streams, SCAN_THREADS, 0, stream>>>(
      tile_counts, tile_offsets, count_out, n_tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  scatter_kernel<<<dim3(n_tiles, n_streams), COMPACT_TILE, 0, stream>>>(
      keys, w, r, g, b, ok, ow, orr, og, ob, tile_offsets, count_out, n);
  return cudaGetLastError();
}

}  // namespace
