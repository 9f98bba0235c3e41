// K6: one level of the stable merge of S key-sorted runs (S <= 32).
//
// Replaces obj2voxel_tpu/ops/merge_pallas.py `merge_runs_pallas` (the level
// kernel `_make_level_kernel` with its Batcher network `_batcher_merge` and
// the merge-path cuts `_level_cuts`).  The TPU version lays its runs out at
// block-aligned offsets padded with INVALID rows and DMAs two windows per
// output block into VMEM; here the runs are dense and every row finds its
// own place, so none of that layout exists.
//
// Level `level` merges the run groups [g, g + 2^level) and
// [g + 2^level, g + 2^(level+1)) for g a multiple of 2^(level+1), each group
// already sorted by the levels before.  One thread per row: a row of the
// left group goes to left_start + its index in the group + the number of
// right keys < its key (lower bound), a row of the right group to
// left_start + its index in the group + the number of left keys <= its key
// (upper bound).  Ties therefore go left, so the merge is stable and its
// result is that of a stable sort of the concatenation.  No atomics: the
// output is deterministic.  A group without a partner is copied through.
//
// Bound on this card: bytes.  Each level reads and writes every row once
// (20 B each way); the binary search adds log2(group) dependent loads per
// row, mostly from L2.  The simple design pays them; a tiled merge-path
// version with shared-memory windows is later work.
#include <cuda_runtime.h>

#define O2V_MAX_RUNS 32

namespace {

constexpr int MERGE_THREADS = 256;

// The S + 1 run boundaries, passed by value so no upload precedes a merge.
struct RunOffsets {
  int off[O2V_MAX_RUNS + 1];
};

// Number of a[0..n) that are < k (strict) or <= k (!strict).
__device__ __forceinline__ int rank_in(const int* __restrict__ a, int n, int k,
                                       bool strict) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int v = __ldg(a + mid);
    if (strict ? v < k : v <= k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(MERGE_THREADS)
merge_level_kernel(const int* __restrict__ keys, const float* __restrict__ w,
                   const float* __restrict__ r, const float* __restrict__ g,
                   const float* __restrict__ b, int* __restrict__ ok,
                   float* __restrict__ ow, float* __restrict__ orr,
                   float* __restrict__ og, float* __restrict__ ob,
                   RunOffsets ro, int n_runs, int level, int n) {
  __shared__ int s_off[O2V_MAX_RUNS + 1];
  if (threadIdx.x <= n_runs) s_off[threadIdx.x] = ro.off[threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (i >= n) return;
  // the run holding row i: the last run that starts at or before it
  // (empty runs start where the next one does and are skipped)
  int run = 0;
  for (int j = 1; j < n_runs; ++j) {
    if (s_off[j] <= i) run = j;
  }
  const int first = (run >> (level + 1)) << (level + 1);
  const int a = s_off[first];
  const int m = s_off[min(first + (1 << level), n_runs)];
  const int e = s_off[min(first + (2 << level), n_runs)];
  const int k = keys[i];
  const int dst = i < m ? i + rank_in(keys + m, e - m, k, true)
                        : a + (i - m) + rank_in(keys + a, m - a, k, false);
  ok[dst] = k;
  ow[dst] = w[i];
  orr[dst] = r[i];
  og[dst] = g[i];
  ob[dst] = b[i];
}

}  // namespace

extern "C" int o2v_merge_runs(const int* keys, const float* w, const float* r,
                              const float* g, const float* b, int* ok,
                              float* ow, float* orr, float* og, float* ob,
                              const int* offsets, int n_runs, int level, int n,
                              void* stream_ptr) {
  if (n_runs < 1 || n_runs > O2V_MAX_RUNS || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RunOffsets ro = {};
  for (int j = 0; j <= n_runs; ++j) ro.off[j] = offsets[j];
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (n + MERGE_THREADS - 1) / MERGE_THREADS;
  merge_level_kernel<<<blocks, MERGE_THREADS, 0, stream>>>(
      keys, w, r, g, b, ok, ow, orr, og, ob, ro, n_runs, level, n);
  return static_cast<int>(cudaGetLastError());
}
