// K3: exact order-preserving compaction of a (key, w, r, g, b) stream.
//
// Replaces obj2voxel_tpu/ops/pack_pallas.py `pack_exact_pallas` (the
// `pack_block` + `flush_exact` kernel), which packs each block in registers
// and flushes it at a running offset carried by the TPU's sequential grid.
//
// Bound on this card: bytes.  Each row is read twice (count, scatter) and
// written once, 20 B each way, with no arithmetic to speak of.  H100 blocks
// run concurrently, so the running offset becomes three launches: per-tile
// live counts, one block that scans the counts, and an ordered scatter
// (o2v_compact.cuh).  Output is the exact dense prefix in input order plus
// the count; rows past the count are (INVALID, 0), so consumers need no mask.
#include "o2v_compact.cuh"

extern "C" const char* o2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int o2v_pack_exact(const int* keys, const float* w, const float* r,
                              const float* g, const float* b, int* ok,
                              float* ow, float* orr, float* og, float* ob,
                              int* count_out, int* tile_counts,
                              int* tile_offsets, int n, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = (n + COMPACT_TILE - 1) / COMPACT_TILE;
  tile_count_kernel<<<n_tiles, COMPACT_TILE, 0, stream>>>(keys, tile_counts,
                                                          n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(compact_from_tile_counts(
      keys, w, r, g, b, ok, ow, orr, og, ob, count_out, tile_counts,
      tile_offsets, n, stream));
}
