// Single-pass chained scan with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016).
//
// It takes the place of a TPU kernel's sequential grid carry: each block of a
// launch adds its own aggregate to the running total of the blocks before it,
// in one pass and without a separate scan launch.
//
// - Blocks take their order from a ticket (`lookback_ticket`), not from
//   blockIdx, so every block that a block waits on has already started and
//   makes progress without waiting itself: the chain cannot deadlock.
// - Each block owns one 64-bit status word: the flag in the high 32 bits,
//   the value in the low 32, written with one store.  A block publishes its
//   aggregate as soon as it knows it, then its inclusive prefix.
// - One warp looks back over its predecessors' words, 32 at a time: it sums
//   aggregates until it meets an inclusive prefix.
// - A block may publish its aggregate (`lookback_publish`) well before it
//   looks back (`lookback_prefix`): K1's batched form clips its next tile in
//   between, so that its predecessors have published by the time it looks.
//
// The status words and the ticket live in scratch that the caller zeroes
// before each launch, so a launch never reads an earlier launch's flags.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned LB_AGGREGATE = 1u;
constexpr unsigned LB_PREFIX = 2u;

__device__ __forceinline__ void lookback_store(unsigned long long* status,
                                               int i, unsigned flag,
                                               int value) {
  *reinterpret_cast<volatile unsigned long long*>(status + i) =
      (static_cast<unsigned long long>(flag) << 32) |
      static_cast<unsigned>(value);
}

__device__ __forceinline__ unsigned long long lookback_load(
    const unsigned long long* status, int i) {
  return *reinterpret_cast<const volatile unsigned long long*>(status + i);
}

// The block's place in the chain.  Every thread of the block must call;
// `s_ticket` is a shared int.
__device__ __forceinline__ int lookback_ticket(int* ticket, int* s_ticket) {
  if (threadIdx.x == 0) *s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  return *s_ticket;
}

// Publish block `tile`'s own total `aggregate`; block 0's is its inclusive
// prefix.  One thread calls it.
__device__ __forceinline__ void lookback_publish(unsigned long long* status,
                                                 int tile, int aggregate) {
  lookback_store(status, tile, tile == 0 ? LB_PREFIX : LB_AGGREGATE,
                 aggregate);
}

// Exclusive prefix of block `tile` of the chain, which has already published
// its `aggregate`; publishes its inclusive prefix.  Called by all 32 lanes
// of one warp; every lane returns it.
__device__ __forceinline__ int lookback_prefix(unsigned long long* status,
                                               int tile, int aggregate) {
  if (tile == 0) return 0;
  const int lane = threadIdx.x & 31;
  int exclusive = 0;
  for (int end = tile;; end -= 32) {
    // lane l reads block end - 1 - l; before block 0 the prefix is 0
    const int i = end - 1 - lane;
    unsigned long long word =
        i >= 0 ? lookback_load(status, i)
               : static_cast<unsigned long long>(LB_PREFIX) << 32;
    while (__any_sync(0xffffffffu, (word >> 32) == 0)) {
      if ((word >> 32) == 0) word = lookback_load(status, i);
    }
    const unsigned prefix =
        __ballot_sync(0xffffffffu, (word >> 32) == LB_PREFIX);
    // sum up to and including the nearest inclusive prefix
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(static_cast<unsigned>(word)) : 0;
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    exclusive += v;
    if (prefix) break;
  }
  if (lane == 0) lookback_store(status, tile, LB_PREFIX, exclusive + aggregate);
  return exclusive;
}

// Exclusive prefix of block `tile` of the chain, whose own total is
// `aggregate`; publishes the block's aggregate and then its inclusive
// prefix.  Called by all 32 lanes of one warp; every lane returns it.
__device__ int lookback_exclusive(unsigned long long* status, int tile,
                                  int aggregate) {
  if ((threadIdx.x & 31) == 0) lookback_publish(status, tile, aggregate);
  return lookback_prefix(status, tile, aggregate);
}

}  // namespace
