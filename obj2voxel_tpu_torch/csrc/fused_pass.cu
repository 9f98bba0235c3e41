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
// uses the same operations in the same order as ops/clip.py with explicit
// round-to-nearest intrinsics, and the build passes --fmad=false, so no FMA
// contraction moves the epsilon plane tests.
//
// The TPU version compacts at a running offset carried by its sequential
// grid.  Here the pass kernel writes slot-ordered rows plus per-tile live
// counts, and the shared scan + ordered scatter (o2v_compact.cuh) produce an
// exact dense prefix in slot order and the count.  Giant-triangle passes
// (`wide_local`) decode the rank with exact integer div/mod, so they run
// through this kernel too.
#include "o2v_compact.cuh"

namespace {

constexpr float kEps = 1.0f / 65536.0f;  // reference EPSILON = 2^-16
constexpr int kSlots = 10;  // closed polygon after six planes: 3 + 6 + 1

// One Sutherland-Hodgman pass (ops/clip.py `_clip_one_plane`): C input slots
// in the closed representation, AXIS and KEEP_HI static.
template <int C, int AXIS, bool KEEP_HI>
__device__ __forceinline__ void clip_plane(const float (&in)[3][kSlots],
                                           int count, float plane,
                                           float (&out)[3][kSlots],
                                           int& new_count) {
  const float* v = in[AXIS];
  bool all_lo = true;
#pragma unroll
  for (int i = 0; i < C - 1; ++i) all_lo &= (v[i] < plane) || (i >= count);

  bool inside[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const float gap = __fsub_rn(plane, v[i]);
    inside[i] = KEEP_HI ? (gap < kEps && !all_lo)
                        : (all_lo || (v[i] < plane && gap >= kEps));
  }

  int n = 0;
#pragma unroll
  for (int i = 0; i < C - 1; ++i) {
    if (i < count) {
      if (inside[i]) {
        if (n <= C) {
#pragma unroll
          for (int c = 0; c < 3; ++c) out[c][n] = in[c][i];
        }
        ++n;
      }
      if (inside[i] != inside[i + 1]) {
        const float d = __fsub_rn(v[i], v[i + 1]);
        const float t =
            fabsf(d) < kEps
                ? 0.0f
                : __fdiv_rn(__fsub_rn(v[i], plane), d == 0.0f ? 1.0f : d);
        const float omt = __fsub_rn(1.0f, t);
        if (n <= C) {
#pragma unroll
          for (int c = 0; c < 3; ++c)
            out[c][n] = __fadd_rn(__fmul_rn(omt, in[c][i]),
                                  __fmul_rn(t, in[c][i + 1]));
        }
        ++n;
      }
    }
  }
  // close the polygon; like ops/clip.py, emissions past slot C are dropped
  // (a convex polygon gains at most one vertex per plane, so this only
  // guards degenerate input)
  if (n <= C) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c][n] = out[c][0];
  }
  new_count = n;
}

// Clipped area of the triangle inside the unit voxel at (vx, vy, vz)
// (ops/clip.py `_clip_polygons` + the weight of `_area_uv`).
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
  int n = 3;
  clip_plane<4, 0, true>(a, n, vx, b, n);
  clip_plane<5, 1, true>(b, n, vy, a, n);
  clip_plane<6, 2, true>(a, n, vz, b, n);
  clip_plane<7, 0, false>(b, n, __fadd_rn(vx, 1.0f), a, n);
  clip_plane<8, 1, false>(a, n, __fadd_rn(vy, 1.0f), b, n);
  clip_plane<9, 2, false>(b, n, __fadd_rn(vz, 1.0f), a, n);

  const float x0 = a[0][0], y0 = a[1][0], z0 = a[2][0];
  float weight = 0.0f;
#pragma unroll
  for (int i = 1; i < kSlots - 1; ++i) {
    if (i + 1 < n) {
      const float ax = __fsub_rn(a[0][i], x0), ay = __fsub_rn(a[1][i], y0),
                  az = __fsub_rn(a[2][i], z0);
      const float bx = __fsub_rn(a[0][i + 1], x0),
                  by = __fsub_rn(a[1][i + 1], y0),
                  bz = __fsub_rn(a[2][i + 1], z0);
      const float cx = __fsub_rn(__fmul_rn(ay, bz), __fmul_rn(az, by));
      const float cy = __fsub_rn(__fmul_rn(az, bx), __fmul_rn(ax, bz));
      const float cz = __fsub_rn(__fmul_rn(ax, by), __fmul_rn(ay, bx));
      const float s = __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)),
                                __fmul_rn(cz, cz));
      weight = __fadd_rn(weight, __fmul_rn(0.5f, __fsqrt_rn(s)));
    }
  }
  return weight;
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
                  int* __restrict__ keys, float* __restrict__ w_out,
                  float* __restrict__ r_out, float* __restrict__ g_out,
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
      const float area = clip_area(t, vxf, vyf, vzf);
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
                              int wide_local, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = (budget + COMPACT_TILE - 1) / COMPACT_TILE;
  fused_pass_kernel<<<n_tiles, COMPACT_TILE, 0, stream>>>(
      table, n_table_rows, r0, n_rows, local_base, z_lo, z_hi, stride,
      log2_expand, budget, wide_local, s_keys, s_w, s_r, s_g, s_b,
      tile_counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(compact_from_tile_counts(
      s_keys, s_w, s_r, s_g, s_b, keys_out, w_out, r_out, g_out, b_out,
      count_out, tile_counts, tile_offsets, budget, stream));
}
