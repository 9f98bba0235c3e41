// K1: one voxelization pass -- slot expansion, rank decode, six-plane clip,
// key and output channels, then ordered compaction of the live pairs.
//
// Replaces obj2voxel_tpu/ops/pass_fused.py `fused_pass_batch_pallas` /
// `fused_pass_pallas` (kernel `_make_kernel`, with the in-kernel pack of
// ops/pack_pallas.py `pack_block` + `flush_packed`), in both of its
// variants: untextured (w, w*r, w*g, w*b) and `textured` (w, u, v: the
// clipped piece's area-weighted UV centroid, for the texture sampling that
// follows; the TPU kernel's fifth channel, zero there, carries the pair's
// table row here, as int32 bits, so that the sampling finds its type, color
// and texture).
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
//   queue skip the clip.  The results go back to their slots through shared
//   memory, so the slot order (MAX ties) is unchanged;
// - the clip stops at an empty polygon and skips a triangle that lies
//   inside the voxel (both exact).
// One thread per slot, row = slot >> log2(expand) (the TPU's MXU one-hot
// expansion does not carry over).  The clip is the same operations in the
// same order as ops/clip.py, with no FMA contraction.
//
// The TPU version compacts at a running offset carried by its sequential
// grid.  Here the pass kernel writes slot-ordered rows plus per-tile live
// counts, and the shared scan + ordered scatter (o2v_compact.cuh) produce an
// exact dense prefix in slot order and the count.  Giant-triangle passes
// (`wide_local`) decode the rank with exact integer div/mod, so they run
// through this kernel too.
//
// With `ref_weights` (the TPU kernel's variant of the same name, the
// engine's input-area weights) an occupied voxel weighs the area of the
// whole table triangle instead of its clipped piece.
//
// The batched form (`o2v_fused_pass_batch`, the TPU kernel's grid
// (nbatch, blocks)) runs up to kMaxBatch untextured passes of one shape
// (expand, budget, stride, ref_weights; never `wide_local`) in one launch of
// a (tiles, passes) grid.  Each pass's (r0, n_rows, local_base, z_lo, z_hi)
// come by value in a kernel parameter, so nothing is uploaded, and each pass
// reads its own table rows in place (the TPU version concatenates the row
// slices first).  The tile body is the single pass's, so pass b's outputs
// equal what one launch of `o2v_fused_pass` gives for it, bit for bit; the
// compaction then runs one scan block a pass and a (tiles, passes) scatter.
#include "o2v_clip.cuh"
#include "o2v_compact.cuh"

namespace {

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

// Tile blockIdx.x of one pass: its slot-ordered rows into keys and c0..c3
// and its live count into tile_counts[blockIdx.x].  Dynamic shared memory:
// the polygon scratch of every thread, then (after the clip) the queue's
// results, 5 words a queue entry.
template <bool TEXTURED>
__device__ __forceinline__ void pass_tile(
    const float* __restrict__ table, int n_table_rows, int r0, int n_rows,
    int local_base, int z_lo, int z_hi, int stride, int log2_expand,
    int budget, int wide_local, int ref_weights, int* __restrict__ keys,
    float* __restrict__ c0, float* __restrict__ c1, float* __restrict__ c2,
    float* __restrict__ c3, int* __restrict__ tile_counts) {
  constexpr int NCH = kChannels<TEXTURED>;
  static_assert(pass_smem_bytes<TEXTURED>() >=
                    5 * COMPACT_TILE * static_cast<int>(sizeof(float)),
                "the result staging reuses the polygon scratch");
  extern __shared__ float s_dyn[];
  __shared__ int s_slot[COMPACT_TILE];       // queue: slot within the tile
  __shared__ float s_vox[3][COMPACT_TILE];   // queue: the slot's voxel
  __shared__ int s_warp[COMPACT_TILE / 32 + 1];

  const int tid = threadIdx.x;
  const int tile0 = blockIdx.x * COMPACT_TILE;
  const int s = tile0 + tid;

  // 1. every slot's voxel; the slots inside their AABB join the queue in
  // slot order
  bool queued = false;
  float vxf = 0.0f, vyf = 0.0f, vzf = 0.0f;
  {
    const int row = s >> log2_expand;
    if (s < budget && row < n_rows && r0 + row < n_table_rows) {
      const int local = local_base + (s & ((1 << log2_expand) - 1));
      queued = slot_voxel(table + static_cast<size_t>(r0 + row) * 24, local,
                          z_lo, z_hi, stride, wide_local, vxf, vyf, vzf);
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
  int key = O2V_INV;
  float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f, o3 = 0.0f;
  if (tid < n_queue) {
    const int row = (tile0 + s_slot[tid]) >> log2_expand;
    const float* __restrict__ t = table + static_cast<size_t>(r0 + row) * 24;
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
    float w = area;
    if (ref_weights && w > 0.0f) w = triangle_area(t);
    if (w > 0.0f) {
      key = (static_cast<int>(vz) - z_lo) * (stride * stride) +
            static_cast<int>(vy) * stride + static_cast<int>(vx);
      o0 = w;
      if constexpr (TEXTURED) {
        // the UV centroid divides by the clipped area, as K4 does
        const float safe_w = area > 0.0f ? area : 1.0f;
        o1 = __fdiv_rn(num_u, safe_w);
        o2 = __fdiv_rn(num_v, safe_w);
        o3 = __int_as_float(r0 + row);
      } else {
        o1 = __fmul_rn(w, t[17]);
        o2 = __fmul_rn(w, t[18]);
        o3 = __fmul_rn(w, t[19]);
      }
    }
  }
  __syncthreads();  // every polygon scratch access is done

  // 3. the queue's results back to their slots, through shared memory
  int* st_key = reinterpret_cast<int*>(s_dyn);
  float* st = s_dyn + COMPACT_TILE;
  if (tid < n_queue) {
    st_key[tid] = key;
    st[tid] = o0;
    st[COMPACT_TILE + tid] = o1;
    st[2 * COMPACT_TILE + tid] = o2;
    st[3 * COMPACT_TILE + tid] = o3;
  }
  __syncthreads();
  key = O2V_INV;
  o0 = o1 = o2 = o3 = 0.0f;
  if (queued) {
    key = st_key[q];
    o0 = st[q];
    o1 = st[COMPACT_TILE + q];
    o2 = st[2 * COMPACT_TILE + q];
    o3 = st[3 * COMPACT_TILE + q];
  }
  if (s < budget) {
    keys[s] = key;
    c0[s] = o0;
    c1[s] = o1;
    c2[s] = o2;
    c3[s] = o3;
  }
  int total;
  block_rank(key != O2V_INV, s_warp, total);
  if (tid == 0) tile_counts[blockIdx.x] = total;
}

template <bool TEXTURED>
__global__ void __launch_bounds__(COMPACT_TILE)
fused_pass_kernel(const float* __restrict__ table, int n_table_rows, int r0,
                  int n_rows, int local_base, int z_lo, int z_hi, int stride,
                  int log2_expand, int budget, int wide_local,
                  int ref_weights, int* __restrict__ keys,
                  float* __restrict__ c0, float* __restrict__ c1,
                  float* __restrict__ c2, float* __restrict__ c3,
                  int* __restrict__ tile_counts) {
  pass_tile<TEXTURED>(table, n_table_rows, r0, n_rows, local_base, z_lo, z_hi,
                      stride, log2_expand, budget, wide_local, ref_weights,
                      keys, c0, c1, c2, c3, tile_counts);
}

constexpr int kMaxBatch = 8;

// The per-pass scalars of a batched launch, a kernel parameter.
struct PassBatch {
  int r0[kMaxBatch], n_rows[kMaxBatch], local_base[kMaxBatch];
  int z_lo[kMaxBatch], z_hi[kMaxBatch];
};

// Grid (tiles, passes): block (t, b) runs tile t of pass b.  Row b of each
// (passes, budget) output, and of the (passes, tiles) counts, is pass b's.
__global__ void __launch_bounds__(COMPACT_TILE)
fused_pass_batch_kernel(const float* __restrict__ table, int n_table_rows,
                        const PassBatch p, int stride, int log2_expand,
                        int budget, int ref_weights, int* __restrict__ keys,
                        float* __restrict__ c0, float* __restrict__ c1,
                        float* __restrict__ c2, float* __restrict__ c3,
                        int* __restrict__ tile_counts) {
  const int b = blockIdx.y;
  // select with static indices: a run-time index into a parameter array
  // could make the compiler copy it to local memory
  int r0 = 0, n_rows = 0, local_base = 0, z_lo = 0, z_hi = 0;
#pragma unroll
  for (int i = 0; i < kMaxBatch; ++i) {
    if (i == b) {
      r0 = p.r0[i];
      n_rows = p.n_rows[i];
      local_base = p.local_base[i];
      z_lo = p.z_lo[i];
      z_hi = p.z_hi[i];
    }
  }
  const size_t off = static_cast<size_t>(b) * budget;
  pass_tile<false>(table, n_table_rows, r0, n_rows, local_base, z_lo, z_hi,
                   stride, log2_expand, budget, 0, ref_weights, keys + off,
                   c0 + off, c1 + off, c2 + off, c3 + off,
                   tile_counts + static_cast<size_t>(b) * gridDim.x);
}

template <bool TEXTURED>
cudaError_t launch_pass(const float* table, int n_table_rows, int r0,
                        int n_rows, int local_base, int z_lo, int z_hi,
                        int stride, int log2_expand, int budget,
                        int wide_local, int ref_weights, int* s_keys,
                        float* s0, float* s1, float* s2, float* s3,
                        int* tile_counts, cudaStream_t stream) {
  constexpr int smem = pass_smem_bytes<TEXTURED>();
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t e = cudaFuncSetAttribute(
      fused_pass_kernel<TEXTURED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int n_tiles = (budget + COMPACT_TILE - 1) / COMPACT_TILE;
  fused_pass_kernel<TEXTURED><<<n_tiles, COMPACT_TILE, smem, stream>>>(
      table, n_table_rows, r0, n_rows, local_base, z_lo, z_hi, stride,
      log2_expand, budget, wide_local, ref_weights, s_keys, s0, s1, s2, s3,
      tile_counts);
  return cudaGetLastError();
}

}  // namespace

// Outputs (key, c0..c3): untextured (w, w*r, w*g, w*b); textured (w, u, v,
// the table row's int32 bits).
extern "C" int o2v_fused_pass(int* keys_out, float* c0_out, float* c1_out,
                              float* c2_out, float* c3_out, int* count_out,
                              int* s_keys, float* s0, float* s1, float* s2,
                              float* s3, int* tile_counts, int* tile_offsets,
                              const float* table, int n_table_rows, int r0,
                              int n_rows, int local_base, int z_lo, int z_hi,
                              int stride, int log2_expand, int budget,
                              int wide_local, int ref_weights, int textured,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t e =
      textured ? launch_pass<true>(table, n_table_rows, r0, n_rows,
                                   local_base, z_lo, z_hi, stride,
                                   log2_expand, budget, wide_local,
                                   ref_weights, s_keys, s0, s1, s2, s3,
                                   tile_counts, stream)
               : launch_pass<false>(table, n_table_rows, r0, n_rows,
                                    local_base, z_lo, z_hi, stride,
                                    log2_expand, budget, wide_local,
                                    ref_weights, s_keys, s0, s1, s2, s3,
                                    tile_counts, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(compact_from_tile_counts(
      s_keys, s0, s1, s2, s3, keys_out, c0_out, c1_out, c2_out, c3_out,
      count_out, tile_counts, tile_offsets, budget, 1, stream));
}

// n_pass untextured passes of one shape in one launch.  `scal` (host) holds
// (r0, n_rows, local_base, z_lo, z_hi) for each pass; every output, and
// each slot-ordered scratch, is (n_pass, budget), the tile counts and
// offsets (n_pass, tiles) and the counts (n_pass,).
extern "C" int o2v_fused_pass_batch(
    int* keys_out, float* c0_out, float* c1_out, float* c2_out,
    float* c3_out, int* counts_out, int* s_keys, float* s0, float* s1,
    float* s2, float* s3, int* tile_counts, int* tile_offsets,
    const float* table, int n_table_rows, const int* scal, int n_pass,
    int stride, int log2_expand, int budget, int ref_weights,
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
  constexpr int smem = pass_smem_bytes<false>();
  cudaError_t e = cudaFuncSetAttribute(
      fused_pass_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = (budget + COMPACT_TILE - 1) / COMPACT_TILE;
  fused_pass_batch_kernel<<<dim3(n_tiles, n_pass), COMPACT_TILE, smem,
                            stream>>>(table, n_table_rows, p, stride,
                                      log2_expand, budget, ref_weights,
                                      s_keys, s0, s1, s2, s3, tile_counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(compact_from_tile_counts(
      s_keys, s0, s1, s2, s3, keys_out, c0_out, c1_out, c2_out, c3_out,
      counts_out, tile_counts, tile_offsets, budget, n_pass, stream));
}
