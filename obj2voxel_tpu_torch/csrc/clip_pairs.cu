// K4: standalone clip of (triangle, voxel) pairs -- per pair the clipped
// area and the area-weighted UV centroid of the piece inside the voxel.
//
// Replaces obj2voxel_tpu/ops/clip_pallas.py `clip_pairs_pallas` (kernel
// `_kernel`).  The engine's textured passes clip in K1's textured variant,
// which reads the table rows itself; K4 keeps the TPU kernel's pair
// contract for callers that hold pairs.
//
// Layout, as on the TPU: channel-major.  tri (16, P): rows 0..8 vertex
// coords, 9..14 UVs (u0 v0 u1 v1 u2 v2), 15 padding; vox (4, P): rows 0..2
// the voxel's min corner; out (4, P): w, u, v, 0.  Any P.
//
// Bound on this card: arithmetic and latency.  A pair reads 72 bytes and
// writes 16, but runs up to six Sutherland-Hodgman passes over five
// channels with IEEE divides and a fan of square roots.  One thread per
// pair; neighbouring threads read neighbouring addresses of each channel
// row, so every load and store is coalesced.  The clip is o2v_clip.cuh, the
// same device code as K1 with the two UV channels carried along (so K4's
// area is K1's bit for bit): the polygon in registers, its emissions in a
// shared-memory scratch of 200 B a thread, an exit at an empty polygon and
// no clip for a triangle inside its voxel.
#include "o2v_clip.cuh"

namespace {

constexpr int kClipThreads = 128;
constexpr int kClipSmem = clip_scratch_bytes(5, kClipThreads);

__global__ void __launch_bounds__(kClipThreads)
clip_pairs_kernel(const float* __restrict__ tri, const float* __restrict__ vox,
                  float* __restrict__ out, int n) {
  __shared__ float s_poly[kClipSmem / sizeof(float)];
  const int p = blockIdx.x * kClipThreads + threadIdx.x;
  if (p >= n) return;
  const size_t P = static_cast<size_t>(n);
  float a[5][kSlots];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) a[c][i] = tri[(3 * i + c) * P + p];
    a[3][i] = tri[(9 + 2 * i) * P + p];
    a[4][i] = tri[(10 + 2 * i) * P + p];
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) a[c][3] = a[c][0];
  const int cnt = clip_voxel<5, kClipThreads>(
      a, vox[p], vox[P + p], vox[2 * P + p],
      PolyScratch<5, kClipThreads>{s_poly + threadIdx.x});
  float num_u, num_v;
  const float w = fan_area<5>(a, cnt, num_u, num_v);
  const float safe_w = w > 0.0f ? w : 1.0f;
  out[p] = w;
  out[P + p] = __fdiv_rn(num_u, safe_w);
  out[2 * P + p] = __fdiv_rn(num_v, safe_w);
  out[3 * P + p] = 0.0f;
}

}  // namespace

extern "C" int o2v_clip_pairs(const float* tri, const float* vox, float* out,
                              int n, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (n + kClipThreads - 1) / kClipThreads;
  clip_pairs_kernel<<<blocks, kClipThreads, 0, stream>>>(tri, vox, out, n);
  return static_cast<int>(cudaGetLastError());
}
