// K2 and K3, and their fusion: one single-pass reduce-by-key over a
// (key, w, r, g, b) stream.
//
// Replaces obj2voxel_tpu/ops/combine_pallas.py `segment_combine_pallas` (K2),
// obj2voxel_tpu/ops/pack_pallas.py `pack_exact_pallas` (K3) and their
// composition in obj2voxel_tpu/ops/combine.py `_combine_sorted_kernel`.  On
// the TPU each runs along the sequential grid and carries the open run (K2)
// or the running offset (K3) in SMEM from block to block.
//
// One kernel template over two switches:
// - COMBINE: the stream is key-sorted.  Each run of equal keys is reduced:
//   BLEND sums the four channels; MAX keeps the element with the strictly
//   greatest w, the earlier one on ties.  The value goes to the run's last
//   row, its tail, found against the global successor key.
// - COMPACT: the tails (with COMBINE) or the live rows (key != INVALID,
//   without) land in input order at a running offset; the last tile writes
//   the count, and a second small launch fills [count, n) with (INVALID, 0).
// `combine_pack` is COMBINE + COMPACT: the slab merge's tail, one read of
// the stream and one write of its unique rows.  `segment_combine` is
// COMBINE alone: every row written at its own place, the tail-marked
// stream.  `pack_exact` is COMPACT alone.
//
// Bound on this card: bytes, 20 B a row read and 20 B a row written.  The
// design keeps the stream's one round trip through device memory:
// - a block owns a tile of 4096 rows (at 2^22 rows the chain has 1024
//   links), takes its place in the chain from a ticket, and stages the tile
//   into shared memory with 16-byte cp.async copies.  A swizzled layout keeps
//   each thread's 16-byte reads of its own 16 consecutive rows free of bank
//   conflicts;
// - each thread reduces its 16 rows in registers; a warp-shuffle scan and a
//   pass over the 8 warps' totals give each thread the run open at its first
//   row.  Tails are ranked by a scan of per-thread counts;
// - two decoupled look-backs (Merrill & Garland) run on two warps at once:
//   the int offset through o2v_lookback.cuh's 64-bit status words, and the
//   run carry (four floats) through a flag word and two float4 slots a tile,
//   each slot written before its flag with a fence between.  A tile that
//   holds the head of a run publishes its inclusive value at once, so a
//   look-back stops there; a tile whose first row starts a run needs no
//   carry and does not wait for one;
// - the results go back into shared memory and leave with coalesced stores.
// The launcher zeroes the flags and the ticket before the pass.
#include "o2v_lookback.cuh"

#define O2V_INV 2147483647

namespace {

constexpr int kRbkThreads = 256;
constexpr int kRbkItems = 16;  // consecutive rows a thread
constexpr int kRbkTile = kRbkThreads * kRbkItems;
constexpr int kRbkWarps = kRbkThreads / 32;
constexpr int kFillRows = 4096;
static_assert(kRbkItems == 16, "the swizzle assumes 4 vectors a thread");

struct V4 {
  float w, r, g, b;
};

// a earlier than b
template <bool BLEND>
__device__ __forceinline__ V4 fold(const V4& a, const V4& b) {
  if (BLEND)
    return {__fadd_rn(a.w, b.w), __fadd_rn(a.r, b.r), __fadd_rn(a.g, b.g),
            __fadd_rn(a.b, b.b)};
  return b.w > a.w ? b : a;
}

template <bool BLEND>
__device__ __forceinline__ V4 identity() {
  return {BLEND ? 0.0f : -__int_as_float(0x7f800000), 0.0f, 0.0f, 0.0f};
}

// A segmented value: whether a run head lies in the span, and the value of
// the run open at the span's end.
struct Seg {
  int head;
  V4 v;
};

template <bool BLEND>
__device__ __forceinline__ Seg seg_fold(const Seg& a, const Seg& b) {
  return {a.head | b.head, b.head ? b.v : fold<BLEND>(a.v, b.v)};
}

__device__ __forceinline__ V4 shfl_v4(const V4& v, int src) {
  return {__shfl_sync(0xffffffffu, v.w, src), __shfl_sync(0xffffffffu, v.r, src),
          __shfl_sync(0xffffffffu, v.g, src), __shfl_sync(0xffffffffu, v.b, src)};
}

__device__ __forceinline__ Seg shfl_up_seg(const Seg& s, int d) {
  return {__shfl_up_sync(0xffffffffu, s.head, d),
          {__shfl_up_sync(0xffffffffu, s.v.w, d),
           __shfl_up_sync(0xffffffffu, s.v.r, d),
           __shfl_up_sync(0xffffffffu, s.v.g, d),
           __shfl_up_sync(0xffffffffu, s.v.b, d)}};
}

__device__ __forceinline__ V4 shfl_down_v4(const V4& v, int d) {
  return {__shfl_down_sync(0xffffffffu, v.w, d),
          __shfl_down_sync(0xffffffffu, v.r, d),
          __shfl_down_sync(0xffffffffu, v.g, d),
          __shfl_down_sync(0xffffffffu, v.b, d)};
}

// Shared-memory place of 16-byte vector `q` of a tile.  Thread t reads
// vectors 4t..4t+3; each quarter-warp's 8 reads of one step then fall in 8
// distinct bank groups, and a warp's 32 consecutive vectors stay in place
// up to a permutation inside aligned groups of 4.
__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 3) & 3); }
__device__ __forceinline__ int swz_row(int e) {
  return (swz(e >> 2) << 2) | (e & 3);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The run-carry chain: per tile a flag (0 none yet, LB_AGGREGATE, LB_PREFIX)
// and two float4 slots, the tile's aggregate and its inclusive value.  A
// reader reads the slot its flag names; each slot is written once, before
// its flag.
struct CarryChain {
  float4* agg;
  float4* incl;
  unsigned* flags;
};

__device__ __forceinline__ void carry_publish(const CarryChain& c, int tile,
                                              unsigned flag, const V4& v) {
  float4* slot = (flag == LB_PREFIX ? c.incl : c.agg) + tile;
  __stcg(slot, make_float4(v.w, v.r, v.g, v.b));
  __threadfence();
  *reinterpret_cast<volatile unsigned*>(c.flags + tile) = flag;
}

// The value of the run open at the end of tile `tile - 1`, over every tile
// before it.  Publishes the tile's own aggregate first (its inclusive value
// when it holds a run head), and its inclusive value at the end.  Called by
// all 32 lanes of one warp; `need` is false when the tile's first row heads
// a run (then it only publishes).
template <bool BLEND>
__device__ V4 carry_exclusive(const CarryChain& c, int tile, const Seg& agg,
                              bool need) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) carry_publish(c, tile, agg.head ? LB_PREFIX : LB_AGGREGATE, agg.v);
  V4 excl = identity<BLEND>();
  if (!need) return excl;
  for (int end = tile;; end -= 32) {
    // lane l reads tile end - 1 - l: higher lanes are earlier tiles
    const int i = end - 1 - lane;
    unsigned f = i >= 0 ? *reinterpret_cast<const volatile unsigned*>(c.flags + i)
                        : LB_PREFIX;
    while (__any_sync(0xffffffffu, f == 0)) {
      if (f == 0) f = *reinterpret_cast<const volatile unsigned*>(c.flags + i);
    }
    __threadfence();
    const unsigned prefix = __ballot_sync(0xffffffffu, f == LB_PREFIX);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    V4 v = identity<BLEND>();
    if (lane <= stop && i >= 0) {
      const float4 x = __ldcg((f == LB_PREFIX ? c.incl : c.agg) + i);
      v = {x.x, x.y, x.z, x.w};
    }
    // fold in order, earliest first: lane 0 gathers lanes 0..31
    for (int d = 1; d < 32; d <<= 1) {
      const V4 u = shfl_down_v4(v, d);
      if (lane + d < 32) v = fold<BLEND>(u, v);
    }
    excl = fold<BLEND>(shfl_v4(v, 0), excl);
    if (prefix) break;
  }
  if (lane == 0 && !agg.head) carry_publish(c, tile, LB_PREFIX, fold<BLEND>(excl, agg.v));
  return excl;
}

// Shared memory: the tile's keys and four channels (swizzled), then with
// COMPACT the tile row of each output, in output order.
template <bool COMPACT>
constexpr int rbk_smem_bytes() {
  return (COMPACT ? 6 : 5) * kRbkTile * static_cast<int>(sizeof(int));
}

struct Rows {
  const int* k;
  const float* c[4];
};

struct OutRows {
  int* k;
  float* c[4];
};

template <bool COMBINE, bool COMPACT, bool BLEND>
__global__ void __launch_bounds__(kRbkThreads, 2)
rbk_kernel(Rows in, OutRows out, int* __restrict__ count_out,
           unsigned long long* status, CarryChain carry, int* ticket, int n,
           int n_tiles, int vec_in, int vec_out) {
  extern __shared__ __align__(16) int s_dyn[];
  int* s_key = s_dyn;
  float* s_ch = reinterpret_cast<float*>(s_dyn + kRbkTile);
  int* s_src = s_dyn + 5 * kRbkTile;
  __shared__ int s_ticket;
  __shared__ int s_edge[2];  // the keys before and after the tile
  __shared__ Seg s_wseg[kRbkWarps];
  __shared__ int s_wcount[kRbkWarps];
  __shared__ int s_offset;
  __shared__ int s_need;  // the tile's first row continues a run
  __shared__ V4 s_carry;

  const int tile = lookback_ticket(ticket, &s_ticket);
  const int base = tile * kRbkTile;
  const int rows = min(kRbkTile, n - base);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // stage the tile; rows past n are (INVALID, 0)
  if (vec_in && rows == kRbkTile) {
    for (int q = tid; q < kRbkTile / 4; q += kRbkThreads) {
      const int s = 4 * swz(q);
      cp_async16(s_key + s, in.k + base + 4 * q);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        cp_async16(s_ch + c * kRbkTile + s, in.c[c] + base + 4 * q);
    }
    cp_async_wait_all();
  } else {
    for (int e = tid; e < kRbkTile; e += kRbkThreads) {
      const bool live = e < rows;
      const int s = swz_row(e);
      s_key[s] = live ? in.k[base + e] : O2V_INV;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s_ch[c * kRbkTile + s] = live ? in.c[c][base + e] : 0.0f;
    }
  }
  if (COMBINE && tid == 0) {
    s_edge[0] = base > 0 ? in.k[base - 1] : O2V_INV;
    s_edge[1] = n - base > kRbkTile ? in.k[base + kRbkTile] : O2V_INV;
  }
  __syncthreads();

  // this thread's rows e0 .. e0 + 15: keys, run heads and tails
  const int e0 = tid * kRbkItems;
  int k[kRbkItems];
#pragma unroll
  for (int q = 0; q < kRbkItems / 4; ++q) {
    const int4 v = reinterpret_cast<const int4*>(s_key)[swz(4 * tid + q)];
    k[4 * q] = v.x;
    k[4 * q + 1] = v.y;
    k[4 * q + 2] = v.z;
    k[4 * q + 3] = v.w;
  }
  unsigned head = 0, tail = 0;
  if (COMBINE) {
    const int prev = tid == 0 ? s_edge[0] : s_key[swz_row(e0 - 1)];
    const int next =
        tid == kRbkThreads - 1 ? s_edge[1] : s_key[swz_row(e0 + kRbkItems)];
#pragma unroll
    for (int j = 0; j < kRbkItems; ++j) {
      const int kp = j == 0 ? prev : k[j - 1];
      const int kn = j == kRbkItems - 1 ? next : k[j + 1];
      if (kp != k[j]) head |= 1u << j;
      if (kn != k[j] && k[j] != O2V_INV) tail |= 1u << j;
    }
    if (base == 0 && tid == 0) head |= 1u;
    if (tid == 0) s_need = !(head & 1u);
  } else {
#pragma unroll
    for (int j = 0; j < kRbkItems; ++j)
      if (k[j] != O2V_INV) tail |= 1u << j;
  }

  // the thread's segmented aggregate: the run open at its last row
  Seg agg{0, identity<BLEND>()};
  if (COMBINE) {
#pragma unroll
    for (int q = 0; q < kRbkItems / 4; ++q) {
      const int s = swz(4 * tid + q);
      const float4 w4 = reinterpret_cast<const float4*>(s_ch)[s];
      const float4 r4 = reinterpret_cast<const float4*>(s_ch + kRbkTile)[s];
      const float4 g4 = reinterpret_cast<const float4*>(s_ch + 2 * kRbkTile)[s];
      const float4 b4 = reinterpret_cast<const float4*>(s_ch + 3 * kRbkTile)[s];
      const V4 v[4] = {{w4.x, r4.x, g4.x, b4.x}, {w4.y, r4.y, g4.y, b4.y},
                       {w4.z, r4.z, g4.z, b4.z}, {w4.w, r4.w, g4.w, b4.w}};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (head >> (4 * q + i) & 1u) {
          agg.head = 1;
          agg.v = v[i];
        } else {
          agg.v = fold<BLEND>(agg.v, v[i]);
        }
      }
    }
  }

  // warp scans: the segmented aggregate (inclusive) and the tail count
  Seg incl = agg;
  const int count = __popc(tail);
  int rank = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (COMBINE) {
      const Seg y = shfl_up_seg(incl, d);
      if (lane >= d) incl = seg_fold<BLEND>(y, incl);
    }
    if (COMPACT) {
      const int y = __shfl_up_sync(0xffffffffu, rank, d);
      if (lane >= d) rank += y;
    }
  }
  if (lane == 31) {
    if (COMBINE) s_wseg[warp] = incl;
    if (COMPACT) s_wcount[warp] = rank;
  }
  __syncthreads();
  // across warps: this thread's exclusive values and the tile's totals
  Seg excl{0, identity<BLEND>()}, tile_agg{0, identity<BLEND>()};
  int before = 0, tile_count = 0;
#pragma unroll
  for (int i = 0; i < kRbkWarps; ++i) {
    if (COMBINE) {
      if (i < warp) excl = seg_fold<BLEND>(excl, s_wseg[i]);
      tile_agg = seg_fold<BLEND>(tile_agg, s_wseg[i]);
    }
    if (COMPACT) {
      before += i < warp ? s_wcount[i] : 0;
      tile_count += s_wcount[i];
    }
  }
  if (COMBINE) {
    const Seg up = shfl_up_seg(incl, 1);
    if (lane > 0) excl = seg_fold<BLEND>(excl, up);
  }
  rank += before - count;  // the exclusive rank of this thread's first tail

  // the chains: the offset on warp 0, the carry on the next warp
  if (COMPACT && warp == 0) {
    const int offset = lookback_exclusive(status, tile, tile_count);
    if (lane == 0) s_offset = offset;
  }
  if (COMBINE && warp == (COMPACT ? 1 : 0)) {
    const V4 c = carry_exclusive<BLEND>(carry, tile, tile_agg, s_need);
    if (lane == 0) s_carry = c;
  }
  __syncthreads();
  const int offset = COMPACT ? s_offset : 0;

  // the results, back into shared memory
  if (COMBINE) {
    V4 acc = excl.head ? excl.v : fold<BLEND>(s_carry, excl.v);
    int p = rank;
#pragma unroll
    for (int q = 0; q < kRbkItems / 4; ++q) {
      const int s = swz(4 * tid + q);
      float4* w4 = reinterpret_cast<float4*>(s_ch) + s;
      float4* r4 = reinterpret_cast<float4*>(s_ch + kRbkTile) + s;
      float4* g4 = reinterpret_cast<float4*>(s_ch + 2 * kRbkTile) + s;
      float4* b4 = reinterpret_cast<float4*>(s_ch + 3 * kRbkTile) + s;
      const float4 x[4] = {*w4, *r4, *g4, *b4};
      V4 v[4] = {{x[0].x, x[1].x, x[2].x, x[3].x}, {x[0].y, x[1].y, x[2].y, x[3].y},
                 {x[0].z, x[1].z, x[2].z, x[3].z}, {x[0].w, x[1].w, x[2].w, x[3].w}};
      int ok[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * q + i;
        acc = (head >> j & 1u) ? v[i] : fold<BLEND>(acc, v[i]);
        const bool t = tail >> j & 1u;
        v[i] = t ? acc : V4{0.0f, 0.0f, 0.0f, 0.0f};
        ok[i] = t ? k[j] : O2V_INV;
        if (COMPACT && t) s_src[p++] = e0 + j;
      }
      *w4 = make_float4(v[0].w, v[1].w, v[2].w, v[3].w);
      *r4 = make_float4(v[0].r, v[1].r, v[2].r, v[3].r);
      *g4 = make_float4(v[0].g, v[1].g, v[2].g, v[3].g);
      *b4 = make_float4(v[0].b, v[1].b, v[2].b, v[3].b);
      if (!COMPACT)
        reinterpret_cast<int4*>(s_key)[s] = make_int4(ok[0], ok[1], ok[2], ok[3]);
    }
  } else {
    int p = rank;
#pragma unroll
    for (int j = 0; j < kRbkItems; ++j)
      if (tail >> j & 1u) s_src[p++] = e0 + j;
  }
  __syncthreads();

  if (COMPACT) {
    // the tile's outputs in order at its offset
    for (int p = tid; p < tile_count; p += kRbkThreads) {
      const int s = swz_row(s_src[p]);
      out.k[offset + p] = s_key[s];
#pragma unroll
      for (int c = 0; c < 4; ++c) out.c[c][offset + p] = s_ch[c * kRbkTile + s];
    }
    if (tile == n_tiles - 1 && tid == 0) *count_out = offset + tile_count;
  } else if (vec_out && rows == kRbkTile) {
    for (int q = tid; q < kRbkTile / 4; q += kRbkThreads) {
      const int s = swz(q);
      reinterpret_cast<int4*>(out.k + base)[q] = reinterpret_cast<const int4*>(s_key)[s];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        reinterpret_cast<float4*>(out.c[c] + base)[q] =
            reinterpret_cast<const float4*>(s_ch + c * kRbkTile)[s];
    }
  } else {
    for (int e = tid; e < rows; e += kRbkThreads) {
      const int s = swz_row(e);
      out.k[base + e] = s_key[s];
#pragma unroll
      for (int c = 0; c < 4; ++c) out.c[c][base + e] = s_ch[c * kRbkTile + s];
    }
  }
}

// (INVALID, 0) over [count, n): 16 B a store where the rows allow.
__global__ void __launch_bounds__(kRbkThreads)
rbk_fill_kernel(const int* __restrict__ count, OutRows out, int n, int vec) {
  const int start = blockIdx.x * kFillRows;
  const int end = start + min(kFillRows, n - start);
  const int lo = max(start, *count);
  if (lo >= end) return;
  // scalar rows [lo, a) and [max(a, v_end), end), vectors [a, v_end)
  const int a = vec ? min(end, (lo + 3) & ~3) : end;
  const int v_end = vec ? end & ~3 : a;
  for (int row = lo + threadIdx.x; row < a; row += kRbkThreads) {
    out.k[row] = O2V_INV;
#pragma unroll
    for (int c = 0; c < 4; ++c) out.c[c][row] = 0.0f;
  }
  const int4 inv = make_int4(O2V_INV, O2V_INV, O2V_INV, O2V_INV);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int q = a / 4 + threadIdx.x; q < v_end / 4; q += kRbkThreads) {
    reinterpret_cast<int4*>(out.k)[q] = inv;
#pragma unroll
    for (int c = 0; c < 4; ++c) reinterpret_cast<float4*>(out.c[c])[q] = zero;
  }
  for (int row = max(a, v_end) + threadIdx.x; row < end; row += kRbkThreads) {
    out.k[row] = O2V_INV;
#pragma unroll
    for (int c = 0; c < 4; ++c) out.c[c][row] = 0.0f;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

template <bool COMBINE, bool COMPACT, bool BLEND>
cudaError_t launch(const Rows& in, const OutRows& out, int* count_out,
                   char* scratch, int n, cudaStream_t stream) {
  const int n_tiles = (n + kRbkTile - 1) / kRbkTile;
  // scratch: agg float4 x tiles, incl float4 x tiles, then the zeroed part:
  // offset status words (u64) x tiles, carry flags (u32) x tiles, the ticket
  CarryChain carry{reinterpret_cast<float4*>(scratch),
                   reinterpret_cast<float4*>(scratch + 16 * n_tiles),
                   reinterpret_cast<unsigned*>(scratch + 40 * n_tiles)};
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(scratch + 32 * n_tiles);
  int* ticket = reinterpret_cast<int*>(scratch + 44 * n_tiles);
  cudaError_t e =
      cudaMemsetAsync(scratch + 32 * n_tiles, 0, 12 * n_tiles + 4, stream);
  if (e != cudaSuccess) return e;
  constexpr int smem = rbk_smem_bytes<COMPACT>();
  // above 48 KB a block's dynamic shared memory must be asked for
  e = cudaFuncSetAttribute(rbk_kernel<COMBINE, COMPACT, BLEND>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  bool vec_in = aligned16(in.k), vec_out = aligned16(out.k);
  for (int c = 0; c < 4; ++c) {
    vec_in = vec_in && aligned16(in.c[c]);
    vec_out = vec_out && aligned16(out.c[c]);
  }
  rbk_kernel<COMBINE, COMPACT, BLEND><<<n_tiles, kRbkThreads, smem, stream>>>(
      in, out, count_out, status, carry, ticket, n, n_tiles, vec_in, vec_out);
  e = cudaGetLastError();
  if (e != cudaSuccess || !COMPACT) return e;
  rbk_fill_kernel<<<(n + kFillRows - 1) / kFillRows, kRbkThreads, 0, stream>>>(
      count_out, out, n, vec_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* o2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// combine / compact pick the instance (at least one).  `scratch` (16-byte
// aligned) holds 44 bytes a 4096-row tile plus 4; the launcher zeroes what
// needs it.  count_out is written only with compact.
extern "C" int o2v_reduce_by_key(const int* keys, const float* w,
                                 const float* r, const float* g,
                                 const float* b, int* ok, float* ow,
                                 float* orr, float* og, float* ob,
                                 int* count_out, void* scratch, int n,
                                 int combine, int compact, int is_blend,
                                 void* stream_ptr) {
  if (n <= 0 || !(combine || compact) || !aligned16(scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Rows in{keys, {w, r, g, b}};
  const OutRows out{ok, {ow, orr, og, ob}};
  char* s = static_cast<char*>(scratch);
  cudaError_t e;
  if (combine && compact)
    e = is_blend ? launch<true, true, true>(in, out, count_out, s, n, stream)
                 : launch<true, true, false>(in, out, count_out, s, n, stream);
  else if (combine)
    e = is_blend ? launch<true, false, true>(in, out, count_out, s, n, stream)
                 : launch<true, false, false>(in, out, count_out, s, n, stream);
  else
    e = launch<false, true, false>(in, out, count_out, s, n, stream);
  return static_cast<int>(e);
}
