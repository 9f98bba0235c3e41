// K2: tail-marked segmented combine of a key-sorted (key, w, r, g, b) stream.
//
// Replaces obj2voxel_tpu/ops/combine_pallas.py `segment_combine_pallas`
// (kernel `_kernel`), which reduces each block with shifted combines and
// carries the open run from block to block in SMEM along the TPU's
// sequential grid.
//
// Semantics: BLEND sums the four channels of a run of equal keys; MAX keeps
// the element with the strictly greatest w, the earlier element winning
// ties.  The last element of every run keeps its key and the combined value;
// every other slot becomes (INVALID, 0).  Tails are detected against the
// global successor key.
//
// Bound on this card: bytes (20 B read and 20 B written per row, plus the
// scanned values once more), but this first version spends more on the
// in-tile Hillis-Steele scan's barriers.  H100 blocks run concurrently, so
// the carry becomes three launches: (1) each tile of SC_TILE rows runs a
// segmented inclusive scan in shared memory and publishes its first key,
// last key and the value of its last run; (2) one block runs the same
// segmented scan over those tile summaries, in key order, so each tile
// learns the combined value of the run open at its end; (3) a fix-up folds
// the previous tile's carry into each tile's first run (the carry is
// earlier, so it wins MAX ties) and writes the tail-marked output.  Both
// combine operators are associative, so MAX stays exact.
#include <cuda_runtime.h>

#define O2V_INV 2147483647

namespace {

constexpr int SC_TILE = 512;
constexpr int CARRY_THREADS = 1024;

struct V4 {
  float w, r, g, b;
};

__device__ __forceinline__ V4 combine(const V4& a, const V4& b, int blend) {
  if (blend)
    return {__fadd_rn(a.w, b.w), __fadd_rn(a.r, b.r), __fadd_rn(a.g, b.g),
            __fadd_rn(a.b, b.b)};
  return b.w > a.w ? b : a;  // a is earlier: it wins ties
}

// In-block segmented inclusive scan over blockDim.x entries in shared
// memory; s_f[i] != 0 marks the head of a segment.  On return s_f[i] says
// whether any head lies in [0, i].
__device__ void seg_scan_shared(int* s_f, V4* s_v, int blend) {
  const int i = threadIdx.x;
  for (int d = 1; d < blockDim.x; d <<= 1) {
    int f = s_f[i];
    V4 v = s_v[i];
    int fp = 0;
    V4 vp = v;
    if (i >= d) {
      fp = s_f[i - d];
      vp = s_v[i - d];
    }
    __syncthreads();
    if (i >= d) {
      if (!f) v = combine(vp, v, blend);
      s_f[i] = f | fp;
      s_v[i] = v;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(SC_TILE)
seg_tile_scan(const int* __restrict__ keys, const float* __restrict__ w,
              const float* __restrict__ r, const float* __restrict__ g,
              const float* __restrict__ b, float* __restrict__ ow,
              float* __restrict__ orr, float* __restrict__ og,
              float* __restrict__ ob, int* __restrict__ key_first,
              int* __restrict__ key_last, float* __restrict__ agg, int n,
              int blend) {
  __shared__ int s_f[SC_TILE];
  __shared__ V4 s_v[SC_TILE];
  const int tid = threadIdx.x;
  const int base = blockIdx.x * SC_TILE;
  const int i = base + tid;
  const bool in = i < n;
  const int k = in ? keys[i] : O2V_INV;
  s_f[tid] = !in || tid == 0 || k != keys[i - 1];
  s_v[tid] = in ? V4{w[i], r[i], g[i], b[i]} : V4{0.0f, 0.0f, 0.0f, 0.0f};
  __syncthreads();
  seg_scan_shared(s_f, s_v, blend);
  if (!in) return;
  const V4 v = s_v[tid];
  ow[i] = v.w;
  orr[i] = v.r;
  og[i] = v.g;
  ob[i] = v.b;
  if (tid == 0) key_first[blockIdx.x] = k;
  if (i == min(n, base + SC_TILE) - 1) {
    key_last[blockIdx.x] = k;
    float* a = agg + 4 * blockIdx.x;
    a[0] = v.w;
    a[1] = v.r;
    a[2] = v.g;
    a[3] = v.b;
  }
}

// carry[t] = the combined value of the run open at the end of tile t,
// including every earlier tile that run spans.
__global__ void __launch_bounds__(CARRY_THREADS)
seg_carry(const int* __restrict__ key_first, const int* __restrict__ key_last,
          const float* __restrict__ agg, float* __restrict__ carry,
          int n_tiles, int blend) {
  __shared__ int s_f[CARRY_THREADS];
  __shared__ V4 s_v[CARRY_THREADS];
  __shared__ V4 s_run;
  const int tid = threadIdx.x;
  for (int start = 0; start < n_tiles; start += CARRY_THREADS) {
    const int t = start + tid;
    if (t < n_tiles) {
      // tile t continues the previous tile's open run only if it is one run
      const bool cont = t > 0 && key_first[t] == key_last[t] &&
                        key_first[t] == key_last[t - 1];
      s_f[tid] = !cont;
      s_v[tid] = V4{agg[4 * t], agg[4 * t + 1], agg[4 * t + 2], agg[4 * t + 3]};
    } else {
      s_f[tid] = 1;
      s_v[tid] = V4{0.0f, 0.0f, 0.0f, 0.0f};
    }
    __syncthreads();
    seg_scan_shared(s_f, s_v, blend);
    V4 c = s_v[tid];
    if (!s_f[tid]) c = combine(s_run, c, blend);  // no head since chunk start
    if (t < n_tiles) {
      float* o = carry + 4 * t;
      o[0] = c.w;
      o[1] = c.r;
      o[2] = c.g;
      o[3] = c.b;
    }
    __syncthreads();
    if (tid == CARRY_THREADS - 1) s_run = c;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(SC_TILE)
seg_fixup(const int* __restrict__ keys, const int* __restrict__ key_last,
          const float* __restrict__ carry, int* __restrict__ ok,
          float* __restrict__ ow, float* __restrict__ orr,
          float* __restrict__ og, float* __restrict__ ob, int n, int blend) {
  const int i = blockIdx.x * SC_TILE + threadIdx.x;
  if (i >= n) return;
  const int t = blockIdx.x;
  const int k = keys[i];
  V4 v{ow[i], orr[i], og[i], ob[i]};
  if (t > 0 && key_last[t - 1] == k) {
    const float* c = carry + 4 * (t - 1);
    v = combine(V4{c[0], c[1], c[2], c[3]}, v, blend);
  }
  const int next = i + 1 < n ? keys[i + 1] : O2V_INV;
  const bool tail = k != next && k != O2V_INV;
  ok[i] = tail ? k : O2V_INV;
  ow[i] = tail ? v.w : 0.0f;
  orr[i] = tail ? v.r : 0.0f;
  og[i] = tail ? v.g : 0.0f;
  ob[i] = tail ? v.b : 0.0f;
}

}  // namespace

extern "C" int o2v_segment_combine(const int* keys, const float* w,
                                   const float* r, const float* g,
                                   const float* b, int* ok, float* ow,
                                   float* orr, float* og, float* ob,
                                   int* key_first, int* key_last, float* agg,
                                   float* carry, int n, int is_blend,
                                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = (n + SC_TILE - 1) / SC_TILE;
  seg_tile_scan<<<n_tiles, SC_TILE, 0, stream>>>(keys, w, r, g, b, ow, orr, og,
                                                 ob, key_first, key_last, agg,
                                                 n, is_blend);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  seg_carry<<<1, CARRY_THREADS, 0, stream>>>(key_first, key_last, agg, carry,
                                             n_tiles, is_blend);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  seg_fixup<<<n_tiles, SC_TILE, 0, stream>>>(keys, key_last, carry, ok, ow,
                                             orr, og, ob, n, is_blend);
  return static_cast<int>(cudaGetLastError());
}
