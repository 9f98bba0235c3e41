// K1: one voxelization pass -- slot expansion, rank decode, six-plane clip,
// key and premultiplied channels, then ordered compaction of the live pairs.
//
// Replaces obj2voxel_tpu/ops/pass_fused.py `fused_pass_batch_pallas` /
// `fused_pass_pallas` (kernel `_make_kernel`, with the in-kernel pack of
// ops/pack_pallas.py `pack_block` + `flush_packed`).
//
// Bound on this card: arithmetic.  A slot reads one 96-byte table row
// (shared by the `expand` slots of its row, so mostly from L1/L2) and writes
// 20 bytes, but runs ~six Sutherland-Hodgman passes of up to ten vertices
// each with IEEE divides and a fan of square roots.  The design keeps it
// simple: one thread per slot, row = slot >> log2(expand) (the TPU's MXU
// one-hot expansion does not carry over), the polygon in per-thread arrays,
// and only the x/y/z channels (untextured passes need no UVs).  The clip
// is o2v_clip.cuh, shared with the standalone clip (K4): the same operations
// in the same order as ops/clip.py, with no FMA contraction.
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
#include "o2v_clip.cuh"
#include "o2v_compact.cuh"

namespace {

// Clipped area of the triangle inside the unit voxel at (vx, vy, vz)
// (ops/clip.py `_clip_polygons` + the weight of `_area_uv`), on the x/y/z
// channels only: untextured passes need no UVs.
__device__ float clip_area(const float* __restrict__ t, float vx, float vy,
                           float vz) {
  float a[3][kSlots], b[3][kSlots];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a[c][0] = t[c];
    a[c][1] = t[3 + c];
    a[c][2] = t[6 + c];
    a[c][3] = t[c];
  }
  const int n = clip_voxel<3>(a, b, vx, vy, vz);
  float unused_u, unused_v;
  return fan_area<3>(a, n, unused_u, unused_v);
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

__global__ void __launch_bounds__(COMPACT_TILE)
fused_pass_kernel(const float* __restrict__ table, int n_table_rows, int r0,
                  int n_rows, int local_base, int z_lo, int z_hi, int stride,
                  int log2_expand, int budget, int wide_local,
                  int ref_weights, int* __restrict__ keys,
                  float* __restrict__ w_out, float* __restrict__ r_out,
                  float* __restrict__ g_out,
                  float* __restrict__ b_out, int* __restrict__ tile_counts) {
  __shared__ int s_warp[COMPACT_TILE / 32 + 1];
  const int s = blockIdx.x * COMPACT_TILE + threadIdx.x;
  int key = O2V_INV;
  float w = 0.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  const int row = s >> log2_expand;
  if (s < budget && row < n_rows && r0 + row < n_table_rows) {
    const float* t = table + static_cast<size_t>(r0 + row) * 24;
    // per-row voxel AABB: the same float ops as the planner
    const int lo[3] = {0, 0, z_lo};
    const int hi[3] = {stride, stride, z_hi};
    int tmin[3], size[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float va = fminf(fminf(t[a], t[a + 3]), t[a + 6]);
      const float vb = fmaxf(fmaxf(t[a], t[a + 3]), t[a + 6]);
      const int t_lo = min(max(static_cast<int>(floorf(va)), lo[a]), hi[a]);
      const int t_hi =
          min(max(static_cast<int>(floorf(vb)) + 1, lo[a]), hi[a]);
      tmin[a] = t_lo;
      size[a] = max(t_hi - t_lo, 0);
    }
    const int sx = max(size[0], 1);
    const int sy = max(size[1], 1);
    const int vol = size[0] * size[1] * size[2];
    const int local = local_base + (s & ((1 << log2_expand) - 1));
    if (local < vol) {
      float vxf, vyf, vzf;
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
      float area = clip_area(t, vxf, vyf, vzf);
      if (ref_weights && area > 0.0f) area = triangle_area(t);
      if (area > 0.0f) {
        const int vx = static_cast<int>(vxf);
        const int vy = static_cast<int>(vyf);
        const int vz = static_cast<int>(vzf);
        key = (vz - z_lo) * (stride * stride) + vy * stride + vx;
        w = area;
        cr = __fmul_rn(w, t[17]);
        cg = __fmul_rn(w, t[18]);
        cb = __fmul_rn(w, t[19]);
      }
    }
  }
  if (s < budget) {
    keys[s] = key;
    w_out[s] = w;
    r_out[s] = cr;
    g_out[s] = cg;
    b_out[s] = cb;
  }
  int total;
  block_rank(key != O2V_INV, s_warp, total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

}  // namespace

extern "C" int o2v_fused_pass(int* keys_out, float* w_out, float* r_out,
                              float* g_out, float* b_out, int* count_out,
                              int* s_keys, float* s_w, float* s_r, float* s_g,
                              float* s_b, int* tile_counts, int* tile_offsets,
                              const float* table, int n_table_rows, int r0,
                              int n_rows, int local_base, int z_lo, int z_hi,
                              int stride, int log2_expand, int budget,
                              int wide_local, int ref_weights,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = (budget + COMPACT_TILE - 1) / COMPACT_TILE;
  fused_pass_kernel<<<n_tiles, COMPACT_TILE, 0, stream>>>(
      table, n_table_rows, r0, n_rows, local_base, z_lo, z_hi, stride,
      log2_expand, budget, wide_local, ref_weights, s_keys, s_w, s_r, s_g,
      s_b, tile_counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(compact_from_tile_counts(
      s_keys, s_w, s_r, s_g, s_b, keys_out, w_out, r_out, g_out, b_out,
      count_out, tile_counts, tile_offsets, budget, stream));
}
