// Triangle / voxel-cube clip device code shared by the fused pass (K1, both
// variants) and the standalone clip (K4), so they cannot drift apart.
//
// The same operations in the same order as ops/clip.py (`_clip_one_plane`,
// `_clip_polygons`, `_area_uv`) with explicit round-to-nearest intrinsics;
// the build passes --fmad=false, so no multiply-add contraction moves the
// epsilon plane tests or the edge-plane intersections.  A polygon is NCH
// channels (x, y, z and optionally u, v) of kSlots vertices in the closed
// representation: slot[count] duplicates slot[0].
//
// Where the polygon lives.  A Sutherland-Hodgman pass writes its i-th
// emission to slot n, with n known only at run time; an array indexed so
// cannot stay in registers, and as two per-thread arrays (240 B a thread for
// 3 channels, 400 B for 5) it went to local memory, whose traffic at full
// occupancy overflows L1 into L2.  Here the polygon lives in registers and is
// only ever indexed by unrolled loop counters; each plane's emissions go to a
// per-thread scratch in shared memory at their run-time slot, and are read
// back into registers at static slots.  The scratch is laid out
// [slot][channel][thread], so a warp touching one (slot, channel) hits 32
// consecutive words: no bank conflicts whatever slot each lane writes.
//
// Two exact shortcuts: a polygon with no vertex left stays empty, so the
// clip stops there; and a triangle whose three vertices pass all six plane
// tests comes through every plane unchanged, so it goes straight to the fan.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1.0f / 65536.0f;  // reference EPSILON = 2^-16
constexpr int kSlots = 10;  // closed polygon after six planes: 3 + 6 + 1

// Shared-memory bytes of the polygon scratch of a block of `threads`.
__host__ __device__ constexpr int clip_scratch_bytes(int nch, int threads) {
  return kSlots * nch * threads * static_cast<int>(sizeof(float));
}

// One thread's polygon scratch: element (slot, channel) at
// base[(slot * NCH + channel) * THREADS], base = &block_scratch[threadIdx.x].
template <int NCH, int THREADS>
struct PolyScratch {
  float* base;
  __device__ __forceinline__ float& at(int slot, int c) const {
    return base[(slot * NCH + c) * THREADS];
  }
};

// The plane test of ops/clip.py `_clip_one_plane` for C input slots (count
// distinct vertices, closed): inside[i] for every slot.
template <int C, bool KEEP_HI>
__device__ __forceinline__ void plane_inside(const float* v, int count,
                                             float plane, bool (&inside)[C]) {
  bool all_lo = true;
#pragma unroll
  for (int i = 0; i < C - 1; ++i) all_lo &= (v[i] < plane) || (i >= count);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const float gap = __fsub_rn(plane, v[i]);
    inside[i] = KEEP_HI ? (gap < kEps && !all_lo)
                        : (all_lo || (v[i] < plane && gap >= kEps));
  }
}

// One Sutherland-Hodgman pass (ops/clip.py `_clip_one_plane`): C input slots
// of `a` in the closed representation, AXIS and KEEP_HI static.  Every
// channel is interpolated with the same t.  Emissions go to the scratch at
// their slot; the closed output is then read back into `a` (slots 0..C).
// Returns the new vertex count.
template <int NCH, int THREADS, int C, int AXIS, bool KEEP_HI>
__device__ __forceinline__ int clip_plane(float (&a)[NCH][kSlots], int count,
                                          float plane,
                                          const PolyScratch<NCH, THREADS>& s) {
  const float* v = a[AXIS];
  bool inside[C];
  plane_inside<C, KEEP_HI>(v, count, plane, inside);

  int n = 0;
#pragma unroll
  for (int i = 0; i < C - 1; ++i) {
    if (i < count) {
      if (inside[i]) {
        if (n <= C) {
#pragma unroll
          for (int c = 0; c < NCH; ++c) s.at(n, c) = a[c][i];
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
          for (int c = 0; c < NCH; ++c)
            s.at(n, c) = __fadd_rn(__fmul_rn(omt, a[c][i]),
                                   __fmul_rn(t, a[c][i + 1]));
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
    for (int c = 0; c < NCH; ++c) s.at(n, c) = s.at(0, c);
  }
  // slots past n + 1 read back whatever an earlier plane left there; like
  // the reference's dead slots, no later test or fan triangle uses them
#pragma unroll
  for (int k = 0; k <= C; ++k) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) a[c][k] = s.at(k, c);
  }
  return n;
}

// Whether the triangle in slots 0..2 passes all six plane tests at every
// vertex: then every plane emits it unchanged.
__device__ __forceinline__ bool inside_all_planes(const float* x,
                                                  const float* y,
                                                  const float* z, float vx,
                                                  float vy, float vz) {
  bool in_lo[3][4], in_hi[3][4];
  plane_inside<4, true>(x, 3, vx, in_lo[0]);
  plane_inside<4, true>(y, 3, vy, in_lo[1]);
  plane_inside<4, true>(z, 3, vz, in_lo[2]);
  plane_inside<4, false>(x, 3, __fadd_rn(vx, 1.0f), in_hi[0]);
  plane_inside<4, false>(y, 3, __fadd_rn(vy, 1.0f), in_hi[1]);
  plane_inside<4, false>(z, 3, __fadd_rn(vz, 1.0f), in_hi[2]);
  bool all = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int i = 0; i < 3; ++i) all &= in_lo[a][i] && in_hi[a][i];
  }
  return all;
}

// The six planes in the reference's order (keep-hi at pos[axis] for x, y,
// z, then keep-lo at pos[axis] + 1).  `a` holds the closed triangle in slots
// 0..3 on entry and the clipped polygon on return.  Returns the vertex count.
template <int NCH, int THREADS>
__device__ __forceinline__ int clip_voxel(float (&a)[NCH][kSlots], float vx,
                                          float vy, float vz,
                                          const PolyScratch<NCH, THREADS>& s) {
  if (inside_all_planes(a[0], a[1], a[2], vx, vy, vz)) return 3;
  int n = clip_plane<NCH, THREADS, 4, 0, true>(a, 3, vx, s);
  if (n == 0) return 0;
  n = clip_plane<NCH, THREADS, 5, 1, true>(a, n, vy, s);
  if (n == 0) return 0;
  n = clip_plane<NCH, THREADS, 6, 2, true>(a, n, vz, s);
  if (n == 0) return 0;
  n = clip_plane<NCH, THREADS, 7, 0, false>(a, n, __fadd_rn(vx, 1.0f), s);
  if (n == 0) return 0;
  n = clip_plane<NCH, THREADS, 8, 1, false>(a, n, __fadd_rn(vy, 1.0f), s);
  if (n == 0) return 0;
  return clip_plane<NCH, THREADS, 9, 2, false>(a, n, __fadd_rn(vz, 1.0f), s);
}

// Area of the clipped polygon by a triangle fan from slot 0 (ops/clip.py
// `_area_uv`); with NCH == 5 also the area-weighted sums of the fan
// triangles' UV centroids, `area * ((u0 + a_u + b_u) / 3)`.
template <int NCH>
__device__ __forceinline__ float fan_area(const float (&a)[NCH][kSlots], int n,
                                          float& num_u, float& num_v) {
  const float x0 = a[0][0], y0 = a[1][0], z0 = a[2][0];
  float weight = 0.0f;
  num_u = 0.0f;
  num_v = 0.0f;
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
      const float area = __fmul_rn(0.5f, __fsqrt_rn(s));
      weight = __fadd_rn(weight, area);
      if constexpr (NCH == 5) {
        const float cu = __fdiv_rn(
            __fadd_rn(__fadd_rn(a[3][0], a[3][i]), a[3][i + 1]), 3.0f);
        const float cv = __fdiv_rn(
            __fadd_rn(__fadd_rn(a[4][0], a[4][i]), a[4][i + 1]), 3.0f);
        num_u = __fadd_rn(num_u, __fmul_rn(area, cu));
        num_v = __fadd_rn(num_v, __fmul_rn(area, cv));
      }
    }
  }
  return weight;
}

}  // namespace
