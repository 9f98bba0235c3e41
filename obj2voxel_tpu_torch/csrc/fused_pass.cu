// K1: voxelization passes -- slot expansion, rank decode, six-plane clip,
// key and output channels, then ordered compaction of the live pairs.
//
// Replaces obj2voxel_tpu/ops/pass_fused.py `fused_pass_batch_pallas` (and
// `fused_pass_pallas`, its nbatch = 1 wrapper; kernel `_make_kernel`, with
// the in-kernel pack of ops/pack_pallas.py `pack_block` + `flush_packed`),
// in both of its variants: untextured (w, w*r, w*g, w*b) and `textured` (w,
// u, v: the clipped piece's area-weighted UV centroid, for the texture
// sampling that follows; the TPU kernel's fifth channel, zero there, carries
// the pair's table row here, as int32 bits, so that the sampling finds its
// type, color and texture).
//
// Bound on this card: arithmetic and latency, not bytes.  A slot reads one
// 96-byte table row (shared by the `expand` slots of its row, so mostly from
// L1/L2) and writes 20 bytes, but runs up to six Sutherland-Hodgman passes
// of up to ten vertices each with IEEE divides and a fan of square roots.
// What the design does about it:
// - the polygon stays in registers, its run-time-indexed emissions go to
//   shared memory (o2v_clip.cuh), so no local memory is touched;
// - a block owns COMPACT_TILE slots; it first decodes every slot's voxel,
//   then queues, in slot order, the slots inside their row's AABB, and the
//   block's first threads clip the queue: the slots past their AABB volume
//   no longer hold lanes idle beside clipping ones, and whole warps past the
//   queue skip the clip;
// - the clip stops at an empty polygon and skips a triangle that lies
//   inside the voxel (both exact).
// One thread per slot, row = slot >> log2(expand) (the TPU's MXU one-hot
// expansion does not carry over).  The clip is the same operations in the
// same order as ops/clip.py, with no FMA contraction.
//
// With `ref_weights` (the TPU kernel's variant of the same name, the
// engine's input-area weights) an occupied voxel weighs the area of the
// whole table triangle instead of its clipped piece.
//
// One launch (`o2v_fused_pass`, the TPU kernel's grid (nbatch, blocks)) runs
// up to kMaxBatch passes of one shape (expand, budget, stride, ref_weights,
// textured, wide_local); a lone pass is a launch of one.  Each pass's (r0,
// n_rows, local_base, z_lo, z_hi) come by value in a kernel parameter,
// copied to shared memory, so nothing is uploaded, and each pass reads its
// own table rows in place (the TPU version concatenates the row slices
// first).  Giant-triangle passes (`wide_local`, one a launch) decode the
// rank with exact integer div/mod.
//
// The TPU version compacts at a running offset carried by its sequential
// grid.  Here the compaction is a decoupled look-back (o2v_lookback.cuh)
// over tickets taken in pass-major order, one chain a pass, so the live
// pairs come out in slot order with an exact count (MAX ties downstream
// depend on that order).  A tile publishes its live count as soon as it is
// clipped, but a look-back right then would hold the block until every
// earlier tile is clipped, and tiles' clip times vary: the slowest tile in
// flight would set the pace of all.  So each block is persistent: it stages
// a clipped tile's live rows, compacted, in shared memory and clips
// kBatchDefer more tiles before it looks back for that tile's offset and
// writes its rows, one contiguous run a channel.  Rows past a pass's count
// are not written (the TPU kernel's pack mode leaves them undefined too).
#include <atomic>

#include "o2v_clip.cuh"
#include "o2v_lookback.cuh"

#define O2V_INV 2147483647

namespace {

// Slots a block clips at a time: one a thread.
constexpr int COMPACT_TILE = 256;

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

// Area of the whole triangle, 0.5 * |e1 x e2| (pass_fused.py:191-197, in
// its order): the weight of every occupied voxel under input-area weights.
__device__ float triangle_area(const float* __restrict__ t) {
  const float e1x = __fsub_rn(t[3], t[0]), e1y = __fsub_rn(t[4], t[1]),
              e1z = __fsub_rn(t[5], t[2]);
  const float e2x = __fsub_rn(t[6], t[0]), e2y = __fsub_rn(t[7], t[1]),
              e2z = __fsub_rn(t[8], t[2]);
  const float cx = __fsub_rn(__fmul_rn(e1y, e2z), __fmul_rn(e1z, e2y));
  const float cy = __fsub_rn(__fmul_rn(e1z, e2x), __fmul_rn(e1x, e2z));
  const float cz = __fsub_rn(__fmul_rn(e1x, e2y), __fmul_rn(e1y, e2x));
  const float sq = __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)),
                             __fmul_rn(cz, cz));
  return __fmul_rn(0.5f, __fsqrt_rn(sq));
}

// Float-reciprocal divmod with one correction step (pass_fused.py
// `_divmod_f`): exact for 0 <= lf < 2^23.
__device__ __forceinline__ void divmod_f(float lf, float sf, float& rem,
                                         float& q) {
  float qq = floorf(__fmul_rn(lf, __fdiv_rn(1.0f, sf)));
  const float r = __fsub_rn(lf, __fmul_rn(qq, sf));
  qq = r < 0.0f ? __fsub_rn(qq, 1.0f) : (r >= sf ? __fadd_rn(qq, 1.0f) : qq);
  rem = __fsub_rn(lf, __fmul_rn(qq, sf));
  q = qq;
}

// The voxel of slot s and whether it lies in its row's AABB (the planner's
// float ops for the AABB; pass_fused.py `_divmod_f` or, for `wide_local`,
// exact integer div/mod for the rank).
__device__ __forceinline__ bool slot_voxel(const float* __restrict__ t,
                                           int local, int z_lo, int z_hi,
                                           int stride, int wide_local,
                                           float& vxf, float& vyf,
                                           float& vzf) {
  const int lo[3] = {0, 0, z_lo};
  const int hi[3] = {stride, stride, z_hi};
  int tmin[3], size[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float va = fminf(fminf(t[a], t[a + 3]), t[a + 6]);
    const float vb = fmaxf(fmaxf(t[a], t[a + 3]), t[a + 6]);
    const int t_lo = min(max(static_cast<int>(floorf(va)), lo[a]), hi[a]);
    const int t_hi = min(max(static_cast<int>(floorf(vb)) + 1, lo[a]), hi[a]);
    tmin[a] = t_lo;
    size[a] = max(t_hi - t_lo, 0);
  }
  const int sx = max(size[0], 1);
  const int sy = max(size[1], 1);
  if (local >= size[0] * size[1] * size[2]) return false;
  if (wide_local) {
    const int rest = local / sx;
    vxf = static_cast<float>(tmin[0] + local % sx);
    vyf = static_cast<float>(tmin[1] + rest % sy);
    vzf = static_cast<float>(tmin[2] + rest / sy);
  } else {
    float mx, rest, my, mz;
    divmod_f(static_cast<float>(local), static_cast<float>(sx), mx, rest);
    divmod_f(rest, static_cast<float>(sy), my, mz);
    vxf = __fadd_rn(static_cast<float>(tmin[0]), mx);
    vyf = __fadd_rn(static_cast<float>(tmin[1]), my);
    vzf = __fadd_rn(static_cast<float>(tmin[2]), mz);
  }
  return true;
}

template <bool TEXTURED>
constexpr int kChannels = TEXTURED ? 5 : 3;

template <bool TEXTURED>
__host__ __device__ constexpr int pass_smem_bytes() {
  return clip_scratch_bytes(kChannels<TEXTURED>, COMPACT_TILE);
}

// A pass's scalars and the tile a block runs.
struct PassTile {
  int r0, n_rows, local_base, z_lo, z_hi, tile;
};

// Tile `pt.tile` of one pass: thread i gets the result (key, o0..o3) of the
// tile's i-th queued slot and threads past the queue (INVALID, 0), so the
// live pairs come out in slot order.  Dynamic shared memory: the polygon
// scratch of every thread.  Every thread of the block must call; `s_warp`
// is block_rank's.  `pt` lives in shared memory and is read where each
// field is used, so that no register holds it across the clip.
template <bool TEXTURED>
__device__ __forceinline__ void pass_tile_body(
    const float* __restrict__ table, int n_table_rows, const PassTile& pt,
    int stride, int log2_expand, int budget, int wide_local, int ref_weights,
    int* s_warp, int& key, float& o0, float& o1, float& o2, float& o3) {
  constexpr int NCH = kChannels<TEXTURED>;
  extern __shared__ float s_dyn[];
  __shared__ int s_slot[COMPACT_TILE];       // queue: slot within the tile
  __shared__ float s_vox[3][COMPACT_TILE];   // queue: the slot's voxel

  const int tid = threadIdx.x;
  const int s = pt.tile * COMPACT_TILE + tid;

  // 1. every slot's voxel; the slots inside their AABB join the queue in
  // slot order
  bool queued = false;
  float vxf = 0.0f, vyf = 0.0f, vzf = 0.0f;
  {
    const int row = s >> log2_expand;
    if (s < budget && row < pt.n_rows && pt.r0 + row < n_table_rows) {
      const int local = pt.local_base + (s & ((1 << log2_expand) - 1));
      queued = slot_voxel(table + static_cast<size_t>(pt.r0 + row) * 24,
                          local, pt.z_lo, pt.z_hi, stride, wide_local, vxf,
                          vyf, vzf);
    }
  }
  int n_queue;
  const int q = block_rank(queued, s_warp, n_queue);
  if (queued) {
    s_slot[q] = tid;
    s_vox[0][q] = vxf;
    s_vox[1][q] = vyf;
    s_vox[2][q] = vzf;
  }
  __syncthreads();

  // 2. the first n_queue threads clip the queue
  key = O2V_INV;
  o0 = o1 = o2 = o3 = 0.0f;
  if (tid < n_queue) {
    const int row = pt.r0 + ((pt.tile * COMPACT_TILE + s_slot[tid]) >>
                             log2_expand);
    const float* __restrict__ t = table + static_cast<size_t>(row) * 24;
    const float vx = s_vox[0][tid], vy = s_vox[1][tid], vz = s_vox[2][tid];
    float a[NCH][kSlots];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) a[c][i] = t[3 * i + c];
      if constexpr (TEXTURED) {
        a[3][i] = t[9 + 2 * i];
        a[4][i] = t[10 + 2 * i];
      }
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) a[c][3] = a[c][0];
    const int cnt = clip_voxel<NCH, COMPACT_TILE>(
        a, vx, vy, vz, PolyScratch<NCH, COMPACT_TILE>{s_dyn + tid});
    float num_u, num_v;
    const float area = fan_area<NCH>(a, cnt, num_u, num_v);
    {
      // rebuild the row's 64-bit pointer from its 32-bit index, through a
      // copy the compiler cannot see into: kept live across the clip, the
      // pointer costs the registers that take the untextured kernel from 4
      // blocks an SM to 3 (ptxas: 70 registers without this, 62 with it)
      int r = row;
      asm volatile("" : "+r"(r));
      t = table + static_cast<size_t>(r) * 24;
    }
    float w = area;
    if (ref_weights && w > 0.0f) w = triangle_area(t);
    if (w > 0.0f) {
      key = (static_cast<int>(vz) - pt.z_lo) * (stride * stride) +
            static_cast<int>(vy) * stride + static_cast<int>(vx);
      o0 = w;
      if constexpr (TEXTURED) {
        // the UV centroid divides by the clipped area, as K4 does
        const float safe_w = area > 0.0f ? area : 1.0f;
        o1 = __fdiv_rn(num_u, safe_w);
        o2 = __fdiv_rn(num_v, safe_w);
        o3 = __int_as_float(row);
      } else {
        o1 = __fmul_rn(w, t[17]);
        o2 = __fmul_rn(w, t[18]);
        o3 = __fmul_rn(w, t[19]);
      }
    }
  }
}

constexpr int kMaxBatch = 8;

// The per-pass scalars of a launch, a kernel parameter.
struct PassBatch {
  int r0[kMaxBatch], n_rows[kMaxBatch], local_base[kMaxBatch];
  int z_lo[kMaxBatch], z_hi[kMaxBatch];
};

// Clipped tiles a block holds, staged, before it looks back for the oldest
// one's offset; it stages one more, the newest.
constexpr int kBatchDefer = 2;
constexpr int kStages = kBatchDefer + 1;
// a staged tile: its live rows in slot order, key then c0..c3
constexpr int kStageWords = 5 * COMPACT_TILE;

template <bool TEXTURED>
__host__ __device__ constexpr int kernel_smem_bytes() {
  return pass_smem_bytes<TEXTURED>() +
         kStages * kStageWords * static_cast<int>(sizeof(float));
}

// The outputs of a launch: (passes, budget) key and c0..c3, the (passes,)
// counts, and the look-back status words, n_tiles a pass.
struct BatchOut {
  int* keys;
  float* c[4];
  int* counts;
  unsigned long long* status;
};

// Look back for the offset of the oldest staged tile (pass b, tile `tile`,
// `total` live rows, staged in `stage`), write its rows there, and, for a
// pass's last tile, the pass's count.  Every thread of the block must call.
__device__ __forceinline__ void batch_resolve(const BatchOut& out,
                                              const float* stage, int b,
                                              int tile, int total, int n_tiles,
                                              int budget, int* s_offset) {
  if (threadIdx.x < 32) {
    const int offset = lookback_prefix(
        out.status + static_cast<size_t>(b) * n_tiles, tile, total);
    if (threadIdx.x == 0) *s_offset = offset;
  }
  __syncthreads();
  const int offset = *s_offset;
  const int i = threadIdx.x;  // total <= COMPACT_TILE: one row a thread
  if (i < total) {
    const size_t dst = static_cast<size_t>(b) * budget + offset + i;
    out.keys[dst] = __float_as_int(stage[i]);
#pragma unroll
    for (int c = 0; c < 4; ++c) out.c[c][dst] = stage[(c + 1) * COMPACT_TILE + i];
  }
  if (tile == n_tiles - 1 && threadIdx.x == 0) out.counts[b] = offset + total;
  __syncthreads();  // s_offset and the stage are free again
}

// Persistent blocks over tickets t = b * n_tiles + tile, pass-major, so each
// pass's chain is contiguous and a tile's predecessors took their tickets
// first.  A block clips the tile of its ticket, publishes its live count,
// stages its live rows compacted, then resolves its oldest staged tile once
// it holds more than kBatchDefer.  Every ticket taken is published after one
// clip with no wait in between, so every look-back ends.  The queue is in
// slot order, so the clipping threads rank and stage their own results.
// The block's state (ticket, pass, tile, ring) lives in shared memory and is
// read where it is used, so that few registers live across the clip: 4
// blocks an SM fit untextured (at most 64 registers; chip_smoke.py phase 2
// fails above that), 3 textured (80 registers, 70 KB of shared memory).  A
// minimum of 4 blocks in the launch bounds would hold the untextured kernel
// there too, but ptxas then trades speed for registers it does not need.
template <bool TEXTURED>
__global__ void __launch_bounds__(COMPACT_TILE)
fused_pass_kernel(const float* __restrict__ table, int n_table_rows,
                  const PassBatch p, int n_tiles, int n_tickets, int stride,
                  int log2_expand, int budget, int wide_local, int ref_weights,
                  const BatchOut out, int* ticket) {
  extern __shared__ float s_dyn[];
  float* const s_stage = s_dyn + pass_smem_bytes<TEXTURED>() / sizeof(float);
  __shared__ PassBatch s_p;
  __shared__ PassTile s_pt;  // the pass and tile of the block's ticket
  __shared__ int s_ticket, s_pass, s_offset;
  __shared__ int s_head, s_held;  // the ring's next entry, its entries
  __shared__ int s_ring[kStages][3];  // each staged tile's pass, tile, total
  __shared__ int s_warp[COMPACT_TILE / 32 + 1];
  if (threadIdx.x == 0) {
    // static indices only: a run-time index into the parameter could make
    // the compiler copy it to local memory
    s_p = p;
    s_head = s_held = 0;
  }
  for (;;) {
    // the block's place in the chains (lookback_ticket's), and its pass
    if (threadIdx.x == 0) {
      const int t = atomicAdd(ticket, 1);
      s_ticket = t;
      if (t < n_tickets) {
        const int b = t / n_tiles;
        s_pass = b;
        s_pt = PassTile{s_p.r0[b],   s_p.n_rows[b], s_p.local_base[b],
                        s_p.z_lo[b], s_p.z_hi[b],   t - b * n_tiles};
      }
    }
    __syncthreads();
    if (s_ticket >= n_tickets) break;
    int key;
    float o[4];
    pass_tile_body<TEXTURED>(table, n_table_rows, s_pt, stride, log2_expand,
                             budget, wide_local, ref_weights, s_warp, key,
                             o[0], o[1], o[2], o[3]);
    const int head = s_head;  // read before block_rank's barriers
    const bool live = key != O2V_INV;
    int total;
    const int rank = block_rank(live, s_warp, total);
    if (threadIdx.x == 0) {
      lookback_publish(out.status + static_cast<size_t>(s_pass) * n_tiles,
                       s_pt.tile, total);
      s_ring[head][0] = s_pass;
      s_ring[head][1] = s_pt.tile;
      s_ring[head][2] = total;
      s_head = head + 1 == kStages ? 0 : head + 1;
      ++s_held;
    }
    float* const stage = s_stage + head * kStageWords;
    if (live) {
      stage[rank] = __int_as_float(key);
#pragma unroll
      for (int c = 0; c < 4; ++c) stage[(c + 1) * COMPACT_TILE + rank] = o[c];
    }
    __syncthreads();
    if (s_held > kBatchDefer) {
      const int e = s_head;  // the oldest: kStages entries back
      batch_resolve(out, s_stage + e * kStageWords, s_ring[e][0],
                    s_ring[e][1], s_ring[e][2], n_tiles, budget, &s_offset);
      if (threadIdx.x == 0) --s_held;  // after batch_resolve's last barrier
    }
  }
  // the tiles still staged, oldest first
  for (int k = s_held; k > 0; --k) {
    const int e = (s_head - k + kStages) % kStages;
    batch_resolve(out, s_stage + e * kStageWords, s_ring[e][0], s_ring[e][1],
                  s_ring[e][2], n_tiles, budget, &s_offset);
  }
}

// Blocks of a persistent launch on the current device: as many as fit on
// the card at once.  Found on the variant's first launch on a device, when
// the shared memory it needs is granted too; both hold for the process, so
// later launches make no query.
constexpr int kMaxDevices = 64;

template <bool TEXTURED>
cudaError_t resident_blocks(int& grid) {
  static std::atomic<int> cache[kMaxDevices];
  int device;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < kMaxDevices && (grid = cache[device].load()) > 0) {
    return cudaSuccess;
  }
  constexpr int smem = kernel_smem_bytes<TEXTURED>();
  int n_sm, per_sm;
  // above 48 KB a block's dynamic shared memory must be asked for
  if ((e = cudaFuncSetAttribute(fused_pass_kernel<TEXTURED>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                  device)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_pass_kernel<TEXTURED>, COMPACT_TILE, smem)) !=
          cudaSuccess) {
    return e;
  }
  grid = n_sm * per_sm;
  if (device < kMaxDevices) cache[device].store(grid);
  return cudaSuccess;
}

template <bool TEXTURED>
cudaError_t launch(const float* table, int n_table_rows, const PassBatch& p,
                   int n_tiles, int n_tickets, int stride, int log2_expand,
                   int budget, int wide_local, int ref_weights,
                   const BatchOut& out, int* ticket, cudaStream_t stream) {
  int grid;
  const cudaError_t e = resident_blocks<TEXTURED>(grid);
  if (e != cudaSuccess) return e;
  if (n_tickets < grid) grid = n_tickets;
  constexpr int smem = kernel_smem_bytes<TEXTURED>();
  fused_pass_kernel<TEXTURED><<<grid, COMPACT_TILE, smem, stream>>>(
      table, n_table_rows, p, n_tiles, n_tickets, stride, log2_expand, budget,
      wide_local, ref_weights, out, ticket);
  return cudaGetLastError();
}

}  // namespace

// n_pass passes of one shape in one launch.  `scal` (host) holds (r0,
// n_rows, local_base, z_lo, z_hi) for each pass; every output is (n_pass,
// budget) and the counts (n_pass,): untextured (key, w, w*r, w*g, w*b),
// textured (key, w, u, v, the table row's int32 bits); rows past a pass's
// count are not written.  `status` (8-byte aligned) holds n_pass * tiles
// look-back status words and then the ticket; they are zeroed here, before
// the pass.
extern "C" int o2v_fused_pass(int* keys_out, float* c0_out, float* c1_out,
                              float* c2_out, float* c3_out, int* counts_out,
                              void* status, const float* table,
                              int n_table_rows, const int* scal, int n_pass,
                              int stride, int log2_expand, int budget,
                              int wide_local, int ref_weights, int textured,
                              void* stream_ptr) {
  if (n_pass < 1 || n_pass > kMaxBatch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  PassBatch p{};
  for (int b = 0; b < n_pass; ++b) {
    p.r0[b] = scal[5 * b];
    p.n_rows[b] = scal[5 * b + 1];
    p.local_base[b] = scal[5 * b + 2];
    p.z_lo[b] = scal[5 * b + 3];
    p.z_hi[b] = scal[5 * b + 4];
  }
  const int n_tiles = (budget + COMPACT_TILE - 1) / COMPACT_TILE;
  const int n_tickets = n_pass * n_tiles;
  unsigned long long* words = static_cast<unsigned long long*>(status);
  const cudaError_t e = cudaMemsetAsync(
      words, 0, (n_tickets + 1) * sizeof(unsigned long long), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const BatchOut out{keys_out, {c0_out, c1_out, c2_out, c3_out}, counts_out,
                     words};
  int* ticket = reinterpret_cast<int*>(words + n_tickets);
  return static_cast<int>(
      textured ? launch<true>(table, n_table_rows, p, n_tiles, n_tickets,
                              stride, log2_expand, budget, wide_local,
                              ref_weights, out, ticket, stream)
               : launch<false>(table, n_table_rows, p, n_tiles, n_tickets,
                               stride, log2_expand, budget, wide_local,
                               ref_weights, out, ticket, stream));
}
