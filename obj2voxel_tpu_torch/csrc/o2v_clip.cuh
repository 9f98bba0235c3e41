// Triangle / voxel-cube clip device code shared by the fused pass (K1) and
// the standalone clip (K4), so the two cannot drift apart.
//
// The same operations in the same order as ops/clip.py (`_clip_one_plane`,
// `_clip_polygons`, `_area_uv`) with explicit round-to-nearest intrinsics;
// the build passes --fmad=false, so no multiply-add contraction moves the
// epsilon plane tests or the edge-plane intersections.  A polygon is NCH
// channels (x, y, z and optionally u, v) of kSlots vertices in the closed
// representation: slot[count] duplicates slot[0].
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1.0f / 65536.0f;  // reference EPSILON = 2^-16
constexpr int kSlots = 10;  // closed polygon after six planes: 3 + 6 + 1

// One Sutherland-Hodgman pass (ops/clip.py `_clip_one_plane`): C input slots
// in the closed representation, AXIS and KEEP_HI static.  Every channel is
// interpolated with the same t.
template <int NCH, int C, int AXIS, bool KEEP_HI>
__device__ __forceinline__ void clip_plane(const float (&in)[NCH][kSlots],
                                           int count, float plane,
                                           float (&out)[NCH][kSlots],
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
          for (int c = 0; c < NCH; ++c) out[c][n] = in[c][i];
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
    for (int c = 0; c < NCH; ++c) out[c][n] = out[c][0];
  }
  new_count = n;
}

// The six planes in the reference's order (keep-hi at pos[axis] for x, y,
// z, then keep-lo at pos[axis] + 1).  `a` holds the closed triangle in slots
// 0..3 on entry and the clipped polygon on return; `b` is scratch.  Returns
// the vertex count.
template <int NCH>
__device__ __forceinline__ int clip_voxel(float (&a)[NCH][kSlots],
                                          float (&b)[NCH][kSlots], float vx,
                                          float vy, float vz) {
  int n = 3;
  clip_plane<NCH, 4, 0, true>(a, n, vx, b, n);
  clip_plane<NCH, 5, 1, true>(b, n, vy, a, n);
  clip_plane<NCH, 6, 2, true>(a, n, vz, b, n);
  clip_plane<NCH, 7, 0, false>(b, n, __fadd_rn(vx, 1.0f), a, n);
  clip_plane<NCH, 8, 1, false>(a, n, __fadd_rn(vy, 1.0f), b, n);
  clip_plane<NCH, 9, 2, false>(b, n, __fadd_rn(vz, 1.0f), a, n);
  return n;
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
