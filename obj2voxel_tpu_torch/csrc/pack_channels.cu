// K5: block-prefix compaction of a (key, w, r, g, b) stream.
//
// Replaces obj2voxel_tpu/ops/pack_pallas.py `pack_channels_pallas` (kernel
// `_pack_kernel`).  Per 8192-slot block, the live rows (key != INVALID) land
// in input order at a running offset, and the offset then advances by the
// block's live count rounded up to 128 rows; the gap is (INVALID, 0) filler.
// `count` is the final offset.  Rows past it are (INVALID, 0) too, where the
// TPU kernel leaves them undefined.
//
// Bound on this card: bytes.  Each key is read once, the channels of the
// live rows once, and the count rows plus the tail written once, with no
// arithmetic to speak of.  The TPU carries the running offset along its
// sequential grid; here one pass does it with a decoupled look-back
// (o2v_lookback.cuh):
// - one block of 256 threads per 8192-slot block keeps its 32 keys a thread
//   in registers and ranks its live rows in input order with warp ballots;
// - it publishes its live count rounded up to 128, looks back for the sum
//   of the blocks before it, and scatters its live rows (the channels read
//   only for them) and its own filler gap at that offset;
// - a second small launch writes (INVALID, 0) over [count, n), reading the
//   count that the last block of the chain wrote.
// The launcher zeroes the status words with a memset before the pass.
#include "o2v_lookback.cuh"

#define O2V_INV 2147483647

namespace {

constexpr int kPackBlock = 8192;
constexpr int kPackRow = 128;
constexpr int kPackThreads = 256;
constexpr int kPackItems = kPackBlock / kPackThreads;
constexpr int kPackWarps = kPackThreads / 32;
// a warp's 32 rows of one item are a slice; slices in input order are
// item-major, warp-minor, and each thread scans the count of one
static_assert(kPackItems * kPackWarps == kPackThreads, "one slice a thread");
constexpr int kTailRows = 2048;

__global__ void __launch_bounds__(kPackThreads)
pack_block_kernel(const int* __restrict__ keys, const float* __restrict__ w,
                  const float* __restrict__ r, const float* __restrict__ g,
                  const float* __restrict__ b, int* __restrict__ ok,
                  float* __restrict__ ow, float* __restrict__ orr,
                  float* __restrict__ og, float* __restrict__ ob,
                  int* __restrict__ count_out,
                  unsigned long long* status, int* ticket,
                  int n_blocks) {
  // live count of each slice, then its exclusive offset in the block
  __shared__ int s_slice[kPackThreads];
  __shared__ int s_warp[kPackWarps];
  __shared__ int s_ticket;
  __shared__ int s_offset;
  const int tile = lookback_ticket(ticket, &s_ticket);
  const int base = tile * kPackBlock;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int k[kPackItems];
#pragma unroll
  for (int j = 0; j < kPackItems; ++j) {
    k[j] = __ldg(keys + base + j * kPackThreads + threadIdx.x);
  }
#pragma unroll
  for (int j = 0; j < kPackItems; ++j) {
    const unsigned live = __ballot_sync(0xffffffffu, k[j] != O2V_INV);
    if (lane == 0) s_slice[j * kPackWarps + warp] = __popc(live);
  }
  __syncthreads();
  // exclusive scan of the slice counts, one a thread
  const int c = s_slice[threadIdx.x];
  int x = c;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int i = 0; i < kPackWarps; ++i) {
    const int t = s_warp[i];
    before += i < warp ? t : 0;
    total += t;
  }
  s_slice[threadIdx.x] = before + x - c;
  const int rounded = (total + kPackRow - 1) / kPackRow * kPackRow;
  if (warp == 0) {
    const int offset = lookback_exclusive(status, tile, rounded);
    if (lane == 0) s_offset = offset;
  }
  __syncthreads();
  const int offset = s_offset;
#pragma unroll
  for (int j = 0; j < kPackItems; ++j) {
    const bool live = k[j] != O2V_INV;
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (live) {
      const int src = base + j * kPackThreads + threadIdx.x;
      const int dst = offset + s_slice[j * kPackWarps + warp] +
                      __popc(mask & ((1u << lane) - 1u));
      ok[dst] = k[j];
      ow[dst] = __ldg(w + src);
      orr[dst] = __ldg(r + src);
      og[dst] = __ldg(g + src);
      ob[dst] = __ldg(b + src);
    }
  }
  // the filler gap up to the rounded end (under 128 rows)
  if (static_cast<int>(threadIdx.x) < rounded - total) {
    const int dst = offset + total + threadIdx.x;
    ok[dst] = O2V_INV;
    ow[dst] = 0.0f;
    orr[dst] = 0.0f;
    og[dst] = 0.0f;
    ob[dst] = 0.0f;
  }
  if (tile == n_blocks - 1 && threadIdx.x == 0) *count_out = offset + rounded;
}

// (INVALID, 0) over [count, n), 16 B a store: count and n are multiples of
// 128 rows, so every 4-row group lies wholly on one side of count.
__global__ void __launch_bounds__(kPackThreads)
pack_tail_kernel(const int* __restrict__ count, int4* __restrict__ ok,
                 float4* __restrict__ ow, float4* __restrict__ orr,
                 float4* __restrict__ og, float4* __restrict__ ob) {
  const int start = blockIdx.x * kTailRows;
  const int n_live = *count;
  if (start + kTailRows <= n_live) return;
  const int4 inv = make_int4(O2V_INV, O2V_INV, O2V_INV, O2V_INV);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int q = threadIdx.x; q < kTailRows / 4; q += kPackThreads) {
    const int row = start + 4 * q;
    if (row >= n_live) {
      ok[row / 4] = inv;
      ow[row / 4] = zero;
      orr[row / 4] = zero;
      og[row / 4] = zero;
      ob[row / 4] = zero;
    }
  }
}

}  // namespace

// n a multiple of 8192.  `status` (8-byte aligned) holds n / 8192 status
// words and then the chain's ticket; they are zeroed here, before the pass,
// so a call never reads an earlier call's flags.
extern "C" int o2v_pack_channels(const int* keys, const float* w,
                                 const float* r, const float* g,
                                 const float* b, int* ok, float* ow,
                                 float* orr, float* og, float* ob,
                                 int* count_out, void* status, int n,
                                 void* stream_ptr) {
  if (n <= 0 || n % kPackBlock) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_blocks = n / kPackBlock;
  unsigned long long* words = static_cast<unsigned long long*>(status);
  cudaError_t e = cudaMemsetAsync(
      words, 0, (n_blocks + 1) * sizeof(unsigned long long), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  pack_block_kernel<<<n_blocks, kPackThreads, 0, stream>>>(
      keys, w, r, g, b, ok, ow, orr, og, ob, count_out, words,
      reinterpret_cast<int*>(words + n_blocks), n_blocks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  pack_tail_kernel<<<n / kTailRows, kPackThreads, 0, stream>>>(
      count_out, reinterpret_cast<int4*>(ok), reinterpret_cast<float4*>(ow),
      reinterpret_cast<float4*>(orr), reinterpret_cast<float4*>(og),
      reinterpret_cast<float4*>(ob));
  return static_cast<int>(cudaGetLastError());
}
