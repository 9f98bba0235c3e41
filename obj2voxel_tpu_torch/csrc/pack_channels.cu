// K5: block-prefix compaction of a (key, w, r, g, b) stream.
//
// Replaces obj2voxel_tpu/ops/pack_pallas.py `pack_channels_pallas` (kernel
// `_pack_kernel`).  Per 8192-slot block, the live rows (key != INVALID) land
// in input order at a running offset, and the offset then advances by the
// block's live count rounded up to 128 rows; the gap is (INVALID, 0) filler.
// `count` is the final offset.  Rows past it are (INVALID, 0) too, where the
// TPU kernel leaves them undefined.
//
// Bound on this card: bytes.  Each row is read twice (count, scatter) and
// written once, with no arithmetic to speak of.  The TPU carries the running
// offset along its sequential grid; here blocks run in parallel, so the
// offset comes from the same scan as the exact pack (K3, o2v_compact.cuh):
// per-tile live counts, with each block's 128-row padding added to the
// count of its last tile, scanned by one block, then the ordered scatter.
// A last small kernel writes the filler gaps, which the scatter skips.
#include "o2v_compact.cuh"

namespace {

constexpr int kPackBlock = 8192;
constexpr int kPackRow = 128;
constexpr int kTilesPerBlock = kPackBlock / COMPACT_TILE;

// One thread per 8192-slot block: copy its tile counts and add the block's
// padding to the last one.
__global__ void pad_counts_kernel(const int* __restrict__ counts,
                                  int* __restrict__ padded, int n_blocks) {
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= n_blocks) return;
  const int base = blk * kTilesPerBlock;
  int n = 0;
  for (int t = 0; t < kTilesPerBlock; ++t) {
    const int c = counts[base + t];
    padded[base + t] = c;
    n += c;
  }
  const int rounded = (n + kPackRow - 1) / kPackRow * kPackRow;
  padded[base + kTilesPerBlock - 1] += rounded - n;
}

// One block of kPackRow threads per 8192-slot block: fill the gap between
// the block's live rows and its rounded end.
__global__ void __launch_bounds__(kPackRow)
fill_gaps_kernel(const int* __restrict__ counts,
                 const int* __restrict__ padded,
                 const int* __restrict__ offsets, int* __restrict__ ok,
                 float* __restrict__ ow, float* __restrict__ orr,
                 float* __restrict__ og, float* __restrict__ ob) {
  const int last = blockIdx.x * kTilesPerBlock + kTilesPerBlock - 1;
  const int start = offsets[last] + counts[last];
  if (static_cast<int>(threadIdx.x) < padded[last] - counts[last]) {
    const int dst = start + threadIdx.x;
    ok[dst] = O2V_INV;
    ow[dst] = 0.0f;
    orr[dst] = 0.0f;
    og[dst] = 0.0f;
    ob[dst] = 0.0f;
  }
}

}  // namespace

extern "C" int o2v_pack_channels(const int* keys, const float* w,
                                 const float* r, const float* g,
                                 const float* b, int* ok, float* ow,
                                 float* orr, float* og, float* ob,
                                 int* count_out, int* tile_counts,
                                 int* padded_counts, int* tile_offsets, int n,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = n / COMPACT_TILE;
  const int n_blocks = n / kPackBlock;
  tile_count_kernel<<<n_tiles, COMPACT_TILE, 0, stream>>>(keys, tile_counts,
                                                          n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  pad_counts_kernel<<<(n_blocks + 255) / 256, 256, 0, stream>>>(
      tile_counts, padded_counts, n_blocks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = compact_from_tile_counts(keys, w, r, g, b, ok, ow, orr, og, ob,
                               count_out, padded_counts, tile_offsets, n,
                               stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  fill_gaps_kernel<<<n_blocks, kPackRow, 0, stream>>>(
      tile_counts, padded_counts, tile_offsets, ok, ow, orr, og, ob);
  return static_cast<int>(cudaGetLastError());
}
