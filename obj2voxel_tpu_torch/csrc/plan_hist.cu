// Plan histogram: stage 1 of the device planner in one pass.
//
// Replaces no Pallas kernel.  It is the hand-written form of the JAX
// planner's jnp `_stage1` (obj2voxel_tpu/ops/plan_device.py:52-64), whose
// plain PyTorch version is ops/plan_device.py `_stage1`.  Per table row the
// voxel AABB: vmin = floor of the vertices' min, vmax = floor of their max
// plus 1, each clamped to [0, (stride, stride, z_extent)] and stored as
// int32.  Over the first n_sub rows, a difference array of the slots each z
// row holds: +sx*sy at bin vmin.z and -sx*sy at bin vmax.z, in int64.
//
// Bound on this card: bytes.  A row's nine vertex floats (the first two
// 32-byte sectors of its 96-byte row) are read once and its two int32
// AABBs written once; the arithmetic is a few min/max, floors and casts.
//
// The plain version adds every row into the difference array with two
// global int64 index_add_, whose atomics are compare-and-swap loops; the
// table's neighbouring triangles share z rows, so thousands of adds collide
// on one address.  This design removes the contended global atomics:
// - persistent blocks each take a contiguous range of rows, a warp 32
//   neighbouring rows at a time, so the row loads coalesce;
// - a warp first sums the adds of its lanes that hit one bin
//   (__match_any_sync, then a tree over the peers), so one add a bin a warp
//   reaches memory;
// - with kShared the block adds into its own shared-memory copy of the bins
//   and at its end flushes each non-zero bin once to the global array with
//   a native 64-bit atomicAdd; without it (more bins than shared memory
//   holds) the warps' sums go straight to the global array.
// Integer sums in any order give one result, so vmin, vmax and the
// histogram are bit-identical to the plain version and deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kHistThreads = 256;
constexpr int kRowFloats = 24;
// dynamic shared memory a block may take without opting in
constexpr size_t kDefaultSmem = 48 * 1024;

// Sums `v` over the lanes of the warp whose `bin` equals this lane's; the
// lowest such lane ends with the sum and returns true.  Every lane of the
// warp must call it.  The peers' values reduce as a tree: each round a lane
// adds the value of the next peer above it that is still in play, and the
// lanes at odd ranks among those in play drop out.
__device__ __forceinline__ bool sum_peers(int bin, unsigned long long& v) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned peers = __match_any_sync(0xffffffffu, bin);
  const bool leader = (peers & below) == 0;
  unsigned rank = __popc(peers & below);
  peers &= ~(below | (1u << lane));
  while (__any_sync(0xffffffffu, peers != 0)) {
    const int next = __ffs(peers);
    const unsigned long long t =
        __shfl_sync(0xffffffffu, v, next ? next - 1 : static_cast<int>(lane));
    if (next) v += t;
    peers &= ~__ballot_sync(0xffffffffu, rank & 1u);
    rank >>= 1;
  }
  return leader;
}

// The voxel cell of coordinate `c` (vmin's floor, or vmax's floor + 1 when
// `upper`), clamped to [0, hi] as the plain version clamps in float32.
__device__ __forceinline__ int cell(float c, bool upper, float hi) {
  float f = floorf(c);
  if (upper) f = __fadd_rn(f, 1.0f);
  return static_cast<int>(fminf(fmaxf(f, 0.0f), hi));
}

template <bool kShared>
__global__ void __launch_bounds__(kHistThreads)
plan_hist_kernel(const float* __restrict__ table, int* __restrict__ vmin,
                 int* __restrict__ vmax, unsigned long long* __restrict__ diff,
                 int n, int n_sub, int stride, int z_extent, int chunk) {
  extern __shared__ unsigned long long s_bins[];
  const int n_bins = z_extent + 1;
  unsigned long long* bins = kShared ? s_bins : diff;
  if (kShared) {
    for (int i = threadIdx.x; i < n_bins; i += kHistThreads) s_bins[i] = 0ull;
    __syncthreads();
  }
  const float hi_xy = static_cast<float>(stride);
  const float hi_z = static_cast<float>(z_extent);
  const int lane = threadIdx.x & 31;
  const long long start = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = start + chunk < n ? start + chunk : n;
  // the loop bound is the warp's, so every lane reaches sum_peers
  for (long long base = start + (threadIdx.x & ~31); base < end;
       base += kHistThreads) {
    const long long row = base + lane;
    int lo = -1, hi = -1;
    unsigned long long area = 0ull;
    if (row < end) {
      const float* p = table + row * kRowFloats;
      // vertices (a.x a.y a.z) (a.w b.x b.y) (b.z b.w c)
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
      const float c = __ldg(p + 8);
      const int x0 = cell(fminf(fminf(a.x, a.w), b.z), false, hi_xy);
      const int y0 = cell(fminf(fminf(a.y, b.x), b.w), false, hi_xy);
      const int z0 = cell(fminf(fminf(a.z, b.y), c), false, hi_z);
      const int x1 = cell(fmaxf(fmaxf(a.x, a.w), b.z), true, hi_xy);
      const int y1 = cell(fmaxf(fmaxf(a.y, b.x), b.w), true, hi_xy);
      const int z1 = cell(fmaxf(fmaxf(a.z, b.y), c), true, hi_z);
      int* lo_out = vmin + row * 3;
      int* hi_out = vmax + row * 3;
      lo_out[0] = x0;
      lo_out[1] = y0;
      lo_out[2] = z0;
      hi_out[0] = x1;
      hi_out[1] = y1;
      hi_out[2] = z1;
      // a row adding 0, or +a and -a into one bin, changes nothing
      if (row < n_sub && z0 != z1) {
        area = static_cast<unsigned long long>(
            static_cast<long long>(x1 - x0) * static_cast<long long>(y1 - y0));
        if (area) {
          lo = z0;
          hi = z1;
        }
      }
    }
    // two's complement: the unsigned sums wrap to the signed ones
    unsigned long long up = area, down = 0ull - area;
    if (sum_peers(lo, up) && lo >= 0) atomicAdd(bins + lo, up);
    if (sum_peers(hi, down) && hi >= 0) atomicAdd(bins + hi, down);
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_bins; i += kHistThreads) {
      const unsigned long long s = s_bins[i];
      if (s) atomicAdd(diff + i, s);
    }
  }
}

}  // namespace

// table (n, 24) float32, 16-byte aligned; vmin, vmax (n, 3) int32; diff
// (z_extent + 1) int64, zeroed by the caller.  shared != 0 keeps the block's
// bins in (z_extent + 1) * 8 B of dynamic shared memory (the caller checks
// that it fits).  Persistent blocks: as many as the card holds at once.
extern "C" int o2v_plan_hist(const float* table, int* vmin, int* vmax,
                             void* diff, int n, int n_sub, int stride,
                             int z_extent, int shared, void* stream_ptr) {
  if (n <= 0 || z_extent < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  void (*kernel)(const float*, int*, int*, unsigned long long*, int, int, int,
                 int, int) =
      shared ? plan_hist_kernel<true> : plan_hist_kernel<false>;
  const size_t smem =
      shared ? static_cast<size_t>(z_extent + 1) * sizeof(unsigned long long) : 0;
  cudaError_t e;
  if (smem > kDefaultSmem) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int device = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kHistThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const long long by_rows = (n + kHistThreads - 1) / kHistThreads;
  const long long want = resident < by_rows ? resident : by_rows;
  // rows a block, in whole warps
  const long long chunk = ((n + want - 1) / want + 31) / 32 * 32;
  const int blocks = static_cast<int>((n + chunk - 1) / chunk);
  kernel<<<blocks, kHistThreads, smem, stream>>>(
      table, vmin, vmax, static_cast<unsigned long long*>(diff), n, n_sub,
      stride, z_extent, static_cast<int>(chunk));
  return static_cast<int>(cudaGetLastError());
}
