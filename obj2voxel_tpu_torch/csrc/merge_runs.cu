// K6: the stable merge of S key-sorted runs (S <= 32), one launch a level.
//
// Replaces obj2voxel_tpu/ops/merge_pallas.py `merge_runs_pallas` (the level
// kernel `_make_level_kernel` with its Batcher network `_batcher_merge` and
// the merge-path cuts `_level_cuts`).  The TPU version lays its runs out at
// block-aligned offsets padded with INVALID rows and DMAs two windows per
// output block into VMEM; here the runs lie densely, one after the other.
//
// Level `level` merges the run groups [g, g + 2^level) and
// [g + 2^level, g + 2^(level+1)) for g a multiple of 2^(level+1), each group
// already sorted by the levels before; a group without a partner is copied
// through.  The wrapper (ops/merge_pallas.py `plan_levels`) plans every
// level: its pairs of groups, (a, m, e) = left start, right start, end, and
// the first output tile of each.
//
// Bound on this card: bytes, 40 B a row once (key and four channels in and
// out).  What the design does about it:
// - The levels move (key, source row) composites, 8 B a row, not the five
//   arrays.  The first level reads the keys and takes each row's source from
//   its index; the last level reads each row's four channels once, by
//   source, and writes the 20 B output row.  Every level before the last
//   writes 8 B a row into scratch the wrapper allocates.
// - The composite is (key ^ sign bit) << 32 | source row.  Runs lie in run
//   order, so ordering composites orders by key, then run, then position:
//   exactly the stable sort.  No two composites are equal, and a left row
//   always precedes a right row of the same key, so the merge is stable and
//   the left group wins every tie.
// - A tiled merge path (ModernGPU, CUB's DeviceMergeSort): each block owns
//   MERGE_TILE output rows of one group pair.  Two warps find the block's
//   start and end cuts in the two groups, each by a 32-ary search (one probe
//   per lane, ~5 rounds of loads for 2^22 rows); the block then loads both
//   segments into shared memory with coalesced loads, each thread finds its
//   own diagonal there by a binary search and merges MERGE_ITEMS rows
//   serially, and the block writes its tile back through shared memory with
//   coalesced stores.  No per-row search in device memory, no scan over the
//   run offsets, no atomics: the output is deterministic.
#include <cuda_runtime.h>

#define O2V_MAX_RUNS 32

namespace {

typedef unsigned long long u64;

constexpr int MERGE_THREADS = 128;
// odd, so that threads' diagonals fall in distinct shared-memory banks
constexpr int MERGE_ITEMS = 15;
constexpr int MERGE_TILE = MERGE_THREADS * MERGE_ITEMS;
constexpr int MAX_PAIRS = O2V_MAX_RUNS / 2;

// One level's group pairs, passed by value so no upload precedes a merge.
struct LevelPlan {
  int a[MAX_PAIRS];
  int m[MAX_PAIRS];
  int e[MAX_PAIRS];
  int tile0[MAX_PAIRS];
};

__device__ __forceinline__ u64 compose(int key, int src) {
  return (static_cast<u64>(static_cast<unsigned>(key) ^ 0x80000000u) << 32) |
         static_cast<unsigned>(src);
}

__device__ __forceinline__ int key_of(u64 v) {
  return static_cast<int>(static_cast<unsigned>(v >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int src_of(u64 v) {
  return static_cast<int>(static_cast<unsigned>(v));
}

// Row `pos` of the level's input as a composite: from the keys on the first
// level, from the previous level's composites after it.
template <bool FIRST>
__device__ __forceinline__ u64 fetch(const int* __restrict__ keys,
                                     const u64* __restrict__ in, int pos) {
  if (FIRST) return compose(__ldg(keys + pos), pos);
  return __ldg(in + pos);
}

// Merge path of A = rows [a, a + na) and B = rows [m, m + nb): the number of
// A rows among the first `diag` rows of their merge, i.e. the first i in
// [lo, hi) where A[i] does not precede B[diag - 1 - i] (hi if none).  Each
// round every lane probes one point of the range and the ballot keeps the
// 1/32 between the last point that precedes and the first that does not.
// Called by all 32 lanes of one warp; every lane returns the result.
template <bool FIRST>
__device__ int warp_merge_path(const int* __restrict__ keys,
                               const u64* __restrict__ in, int a, int m,
                               int na, int nb, int diag) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, diag - nb);
  int hi = min(diag, na);
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + (lane + 1) * step - 1;
    const bool before =
        i < hi && fetch<FIRST>(keys, in, a + i) <=
                      fetch<FIRST>(keys, in, m + diag - 1 - i);
    const int c = __popc(__ballot_sync(0xffffffffu, before));
    const int new_lo = lo + c * step;
    hi = min(new_lo + step - 1, hi);
    lo = new_lo;
  }
  const int i = lo + lane;
  const bool before = i < hi && fetch<FIRST>(keys, in, a + i) <=
                                   fetch<FIRST>(keys, in, m + diag - 1 - i);
  return lo + __popc(__ballot_sync(0xffffffffu, before));
}

// The same cut inside the tile: s[0, na) holds A and s[na, na + nb) holds B.
__device__ __forceinline__ int smem_merge_path(const u64* s, int na, int nb,
                                               int diag) {
  int lo = max(0, diag - nb);
  int hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= s[na + diag - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <bool FIRST, bool LAST>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_level_kernel(const int* __restrict__ keys, const float* __restrict__ w,
                   const float* __restrict__ r, const float* __restrict__ g,
                   const float* __restrict__ b, int* __restrict__ ok,
                   float* __restrict__ ow, float* __restrict__ orr,
                   float* __restrict__ og, float* __restrict__ ob,
                   const u64* __restrict__ in, u64* __restrict__ out,
                   LevelPlan plan, int n_pairs) {
  __shared__ u64 s[MERGE_TILE];
  __shared__ int s_cut[2];
  // the block's group pair: the last one whose first tile is at or before
  // the block (a pair without rows has no tile and is passed over)
  const int tile = blockIdx.x;
  int p = 0;
  for (int j = 1; j < n_pairs; ++j) {
    if (plan.tile0[j] <= tile) p = j;
  }
  const int a = plan.a[p];
  const int m = plan.m[p];
  const int na = m - a;
  const int nb = plan.e[p] - m;
  const int d0 = (tile - plan.tile0[p]) * MERGE_TILE;
  const int d1 = min(d0 + MERGE_TILE, na + nb);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int cut = warp_merge_path<FIRST>(keys, in, a, m, na, nb,
                                           warp == 0 ? d0 : d1);
    if ((threadIdx.x & 31) == 0) s_cut[warp] = cut;
  }
  __syncthreads();
  const int i0 = s_cut[0];
  const int ca = s_cut[1] - i0;
  const int n_tile = d1 - d0;
  const int cb = n_tile - ca;
  const int j0 = d0 - i0;
  // the tile's two segments into shared memory, coalesced
  for (int i = threadIdx.x; i < n_tile; i += MERGE_THREADS) {
    s[i] = i < ca ? fetch<FIRST>(keys, in, a + i0 + i)
                  : fetch<FIRST>(keys, in, m + j0 + i - ca);
  }
  __syncthreads();
  // each thread merges MERGE_ITEMS rows from its own diagonal
  const int diag = min(static_cast<int>(threadIdx.x) * MERGE_ITEMS, n_tile);
  int ia = smem_merge_path(s, ca, cb, diag);
  int ib = diag - ia;
  u64 va = ia < ca ? s[ia] : 0;
  u64 vb = ib < cb ? s[ca + ib] : 0;
  u64 v[MERGE_ITEMS];
#pragma unroll
  for (int j = 0; j < MERGE_ITEMS; ++j) {
    if (diag + j < n_tile) {
      const bool take_a = ib >= cb || (ia < ca && va <= vb);
      if (take_a) {
        v[j] = va;
        ++ia;
        va = ia < ca ? s[ia] : 0;
      } else {
        v[j] = vb;
        ++ib;
        vb = ib < cb ? s[ca + ib] : 0;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < MERGE_ITEMS; ++j) {
    if (diag + j < n_tile) s[diag + j] = v[j];
  }
  __syncthreads();
  // the tile out, coalesced; the last level gathers each row's channels by
  // its source
  const int base = a + d0;
  for (int i = threadIdx.x; i < n_tile; i += MERGE_THREADS) {
    const u64 x = s[i];
    if (LAST) {
      const int src = src_of(x);
      ok[base + i] = key_of(x);
      ow[base + i] = __ldg(w + src);
      orr[base + i] = __ldg(r + src);
      og[base + i] = __ldg(g + src);
      ob[base + i] = __ldg(b + src);
    } else {
      out[base + i] = x;
    }
  }
}

template <bool FIRST, bool LAST>
cudaError_t launch(const int* keys, const float* w, const float* r,
                   const float* g, const float* b, int* ok, float* ow,
                   float* orr, float* og, float* ob, const u64* in, u64* out,
                   const int* plan, cudaStream_t stream) {
  const int n_pairs = plan[0];
  if (n_pairs < 1 || n_pairs > MAX_PAIRS) return cudaErrorInvalidValue;
  LevelPlan lp = {};
  for (int j = 0; j < n_pairs; ++j) {
    lp.a[j] = plan[1 + 4 * j];
    lp.m[j] = plan[2 + 4 * j];
    lp.e[j] = plan[3 + 4 * j];
    lp.tile0[j] = plan[4 + 4 * j];
  }
  const int tiles = plan[1 + 4 * n_pairs];
  if (tiles <= 0) return cudaErrorInvalidValue;
  merge_level_kernel<FIRST, LAST><<<tiles, MERGE_THREADS, 0, stream>>>(
      keys, w, r, g, b, ok, ow, orr, og, ob, in, out, lp, n_pairs);
  return cudaGetLastError();
}

}  // namespace

// The whole merge: one launch a level.  `plan` (host) holds, for each of
// the n_levels levels, its number of group pairs, then (a, m, e, first
// tile) for each pair, then the level's tile count.  The first level reads
// `keys`; every level but the last writes its composites into `scratch`
// (two buffers of n rows, or one when there are two levels), which the next
// level reads; the last level writes the five output arrays.
extern "C" int o2v_merge_runs(const int* keys, const float* w, const float* r,
                              const float* g, const float* b, int* ok,
                              float* ow, float* orr, float* og, float* ob,
                              void* scratch, const int* plan, int n_levels,
                              int n, void* stream_ptr) {
  if (n_levels < 1 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  u64* buf[2] = {static_cast<u64*>(scratch),
                 static_cast<u64*>(scratch) + (n_levels > 2 ? n : 0)};
  for (int level = 0; level < n_levels; ++level) {
    const bool first = level == 0;
    const bool last = level == n_levels - 1;
    const u64* in = first ? nullptr : buf[(level - 1) % 2];
    u64* out = last ? nullptr : buf[level % 2];
    cudaError_t e;
    if (first && last) {
      e = launch<true, true>(keys, w, r, g, b, ok, ow, orr, og, ob, in, out,
                             plan, stream);
    } else if (first) {
      e = launch<true, false>(keys, w, r, g, b, ok, ow, orr, og, ob, in, out,
                              plan, stream);
    } else if (last) {
      e = launch<false, true>(keys, w, r, g, b, ok, ow, orr, og, ob, in, out,
                              plan, stream);
    } else {
      e = launch<false, false>(keys, w, r, g, b, ok, ow, orr, og, ob, in, out,
                               plan, stream);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    plan += 2 + 4 * plan[0];
  }
  return static_cast<int>(cudaSuccess);
}
