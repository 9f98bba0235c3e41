// Plan keys and plan scatter: stage 2 of the device planner as a stable
// counting sort.
//
// Replaces no Pallas kernel.  It is the hand-written form of the JAX
// planner's jnp `_stage2` (obj2voxel_tpu/ops/plan_device.py), whose plain
// PyTorch version is ops/plan_device.py `_stage2`: over every (group, slab)
// incidence the key slab*64 + ceil_log2(the largest slab-clamped AABB volume
// of the group's live rows), or s_pad*64 where no row of the group is live
// in the slab; a stable sort of the keys in (group, slab) order carries the
// group ids; the segment bounds count the keys below each bin.
//
// Bound on this card: bytes.  Each live row's two int32 AABBs are read once
// (24 B); a 16-bit key is written and read once per (group, slab); each live
// incidence's group id is written once (8 B).  The plain version builds
// (rows x s_pad) int64 matrices (eight of them alive at once) and radix-sorts
// the flat key with an int64 payload.
//
// This design keeps the per-slab values in registers:
// - plan_keys_kernel: a warp owns one contiguous range of groups, a thread
//   one group at a time.  The thread reads its group's rows (16-byte loads of
//   four rows at a time where the group holds a multiple of four), takes each
//   slab's max of k = bit length of (volume - 1) over the live rows, and
//   writes the s_pad keys as uint16, slab-major.  The warp counts its keys
//   per bin in its own shared-memory row (one add a bin a warp:
//   __match_any_sync, the lowest peer adds), and writes the row as one
//   column of the (bin, warp) count matrix.
// - the caller scans the count matrix bin-major (torch.cumsum): each warp's
//   base in each bin, and each bin's bound.
// - plan_scatter_kernel: each warp walks its range again in the same order,
//   keeps a running position per bin in shared memory, and writes each live
//   incidence's group id at its bin's position plus its rank among the lanes
//   below it with the same key.  A bin holds one slab, so ties come out in
//   ascending group id: the order of a stable sort on the flat key.
// Integer keys and counts: the order and bounds are bit-identical to the
// plain version's, and deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSlabs = 32;

// The slabs' z rows [lo, hi), padded past n_slabs; passed by value.
struct Slabs {
  int lo[kMaxSlabs];
  int hi[kMaxSlabs];
};

// Adds one row's slab keys into the group's running max: k = ceil(log2(c))
// of its slab-clamped volume c = sx * sy * dz (0 for c <= 1), for each slab
// the row reaches.  c < 2^31 by slab construction, so the bit length of
// c - 1 equals the plain version's frexp exponent.
template <int S>
__device__ __forceinline__ void add_row(int x0, int y0, int z0, int x1, int y1,
                                        int z1, int n_slabs, const Slabs& slabs,
                                        int (&kmax)[S]) {
  const int sx = x1 - x0, sy = y1 - y0;
  if (sx <= 0 || sy <= 0) return;
  const long long area = static_cast<long long>(sx) * sy;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int dz = min(z1, slabs.hi[s]) - max(z0, slabs.lo[s]);
    if (s < n_slabs && dz > 0) {
      const long long c = area * dz;
      const int k = c <= 1 ? 0 : 64 - __clzll(c - 1);
      kmax[s] = max(kmax[s], k);
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads)
plan_keys_kernel(const int* __restrict__ vmin, const int* __restrict__ vmax,
                 unsigned short* __restrict__ keys, int* __restrict__ counts,
                 int n_act, int n_sub, int group, int n_slabs, Slabs slabs,
                 int units, int chunk) {
  constexpr int kBins = S * 64;
  __shared__ int s_cnt[kWarps][kBins];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWarps + warp;
  if (u >= units) return;  // the whole warp
  int* cnt = s_cnt[warp];
  for (int i = lane; i < kBins; i += 32) cnt[i] = 0;
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  const long long start = static_cast<long long>(u) * chunk;
  const long long end = start + chunk < n_act ? start + chunk : n_act;
  // the loop bound is the warp's, so every lane reaches the match
  for (long long base = start; base < end; base += 32) {
    const long long g = base + lane;
    int kmax[S];
#pragma unroll
    for (int s = 0; s < S; ++s) kmax[s] = -1;
    if (g < end) {
      const long long r0 = g * group;
      const long long r1 = r0 + group < n_sub ? r0 + group : n_sub;
      if ((group & 3) == 0) {
        // four rows = 48 B = three 16-byte loads from each array
        for (long long r = r0; r < r1; r += 4) {
          const int4* lo = reinterpret_cast<const int4*>(vmin + r * 3);
          const int4* hi = reinterpret_cast<const int4*>(vmax + r * 3);
          const int4 a0 = __ldg(lo), a1 = __ldg(lo + 1), a2 = __ldg(lo + 2);
          const int4 b0 = __ldg(hi), b1 = __ldg(hi + 1), b2 = __ldg(hi + 2);
          add_row<S>(a0.x, a0.y, a0.z, b0.x, b0.y, b0.z, n_slabs, slabs, kmax);
          if (r + 1 < r1)
            add_row<S>(a0.w, a1.x, a1.y, b0.w, b1.x, b1.y, n_slabs, slabs, kmax);
          if (r + 2 < r1)
            add_row<S>(a1.z, a1.w, a2.x, b1.z, b1.w, b2.x, n_slabs, slabs, kmax);
          if (r + 3 < r1)
            add_row<S>(a2.y, a2.z, a2.w, b2.y, b2.z, b2.w, n_slabs, slabs, kmax);
        }
      } else {
        for (long long r = r0; r < r1; ++r) {
          const int* lo = vmin + r * 3;
          const int* hi = vmax + r * 3;
          add_row<S>(__ldg(lo), __ldg(lo + 1), __ldg(lo + 2), __ldg(hi),
                     __ldg(hi + 1), __ldg(hi + 2), n_slabs, slabs, kmax);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int bin = kmax[s] >= 0 ? s * 64 + kmax[s] : kBins;
      if (g < end)
        keys[static_cast<long long>(s) * n_act + g] =
            static_cast<unsigned short>(bin);
      // one slab's bins are its own: the leaders of one round add to
      // distinct counters
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin < kBins && (peers & below) == 0) cnt[bin] += __popc(peers);
    }
    __syncwarp();
  }
  __syncwarp();
  for (int i = lane; i < kBins; i += 32)
    counts[static_cast<long long>(i) * units + u] = cnt[i];
}

template <int S>
__global__ void __launch_bounds__(kThreads)
plan_scatter_kernel(const unsigned short* __restrict__ keys,
                    const int* __restrict__ counts,
                    const int* __restrict__ inclusive,
                    long long* __restrict__ order, int n_act, int units,
                    int chunk) {
  constexpr int kBins = S * 64;
  __shared__ int s_run[kWarps][kBins];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWarps + warp;
  if (u >= units) return;  // the whole warp
  int* run = s_run[warp];
  // the warp's first position in each bin: the bin-major exclusive scan
  for (int i = lane; i < kBins; i += 32) {
    const long long j = static_cast<long long>(i) * units + u;
    run[i] = inclusive[j] - counts[j];
  }
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  const long long start = static_cast<long long>(u) * chunk;
  const long long end = start + chunk < n_act ? start + chunk : n_act;
  for (long long base = start; base < end; base += 32) {
    const long long g = base + lane;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int bin =
          g < end ? keys[static_cast<long long>(s) * n_act + g] : kBins;
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      const int leader = __ffs(peers) - 1;
      int pos = 0;
      if (lane == leader && bin < kBins) {
        pos = run[bin];
        run[bin] = pos + __popc(peers);
      }
      pos = __shfl_sync(0xffffffffu, pos, leader);
      if (bin < kBins) order[pos + __popc(peers & below)] = g;
    }
    __syncwarp();
  }
}

bool valid_slabs(int s_pad) {
  return s_pad == 1 || s_pad == 2 || s_pad == 4 || s_pad == 8 ||
         s_pad == 16 || s_pad == 32;
}

}  // namespace

// vmin, vmax (N, 3) int32, 16-byte aligned; keys (s_pad, n_act) uint16;
// counts (s_pad * 64, units) int32, every entry written.  n_act groups of
// `group` rows are keyed (rows past n_sub are dead); starts, stops: host
// arrays of s_pad slab rows.  Warp u takes groups [u * chunk, (u+1) * chunk).
extern "C" int o2v_plan_keys(const int* vmin, const int* vmax, void* keys,
                             int* counts, int n_act, int n_sub, int group,
                             int s_pad, int n_slabs, const int* starts,
                             const int* stops, int units, int chunk,
                             void* stream_ptr) {
  if (!valid_slabs(s_pad) || n_slabs < 0 || n_slabs > s_pad || n_act < 0 ||
      group < 1 || units < 1 || chunk < 32 || chunk % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  Slabs slabs = {};
  for (int s = 0; s < s_pad; ++s) {
    slabs.lo[s] = starts[s];
    slabs.hi[s] = stops[s];
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (units + kWarps - 1) / kWarps;
  unsigned short* k = static_cast<unsigned short*>(keys);
#define O2V_PLAN_KEYS(S)                                                    \
  case S:                                                                   \
    plan_keys_kernel<S><<<blocks, kThreads, 0, stream>>>(                   \
        vmin, vmax, k, counts, n_act, n_sub, group, n_slabs, slabs, units,  \
        chunk);                                                             \
    break;
  switch (s_pad) {
    O2V_PLAN_KEYS(1)
    O2V_PLAN_KEYS(2)
    O2V_PLAN_KEYS(4)
    O2V_PLAN_KEYS(8)
    O2V_PLAN_KEYS(16)
    O2V_PLAN_KEYS(32)
  }
#undef O2V_PLAN_KEYS
  return static_cast<int>(cudaGetLastError());
}

// keys and counts as o2v_plan_keys left them; inclusive: the inclusive
// bin-major scan of counts (int32); order: the live total of int64 group ids.
extern "C" int o2v_plan_scatter(const void* keys, const int* counts,
                                const int* inclusive, long long* order,
                                int n_act, int s_pad, int units, int chunk,
                                void* stream_ptr) {
  if (!valid_slabs(s_pad) || n_act < 0 || units < 1 || chunk < 32 ||
      chunk % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (units + kWarps - 1) / kWarps;
  const unsigned short* k = static_cast<const unsigned short*>(keys);
#define O2V_PLAN_SCATTER(S)                                                 \
  case S:                                                                   \
    plan_scatter_kernel<S><<<blocks, kThreads, 0, stream>>>(                \
        k, counts, inclusive, order, n_act, units, chunk);                  \
    break;
  switch (s_pad) {
    O2V_PLAN_SCATTER(1)
    O2V_PLAN_SCATTER(2)
    O2V_PLAN_SCATTER(4)
    O2V_PLAN_SCATTER(8)
    O2V_PLAN_SCATTER(16)
    O2V_PLAN_SCATTER(32)
  }
#undef O2V_PLAN_SCATTER
  return static_cast<int>(cudaGetLastError());
}
