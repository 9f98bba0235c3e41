"""A queue model of a decoupled look-back behind an expensive tile: how long
W resident blocks take for N tiles whose times vary, when each block's
output offset waits for every earlier tile's count.

    python3 scripts/lookback_queue_model.py [--blocks 528] [--tiles 65536]

Tiles are handed out in ticket order to the first free block; tile times
are lognormal with mean about 1 and spread sigma.  Three schedules:
- free: a block is free again as soon as its tile is done (no look-back,
  as when a separate scan launch places the rows);
- immediate: a block looks back right after its tile, so it is free only
  once every earlier tile is done;
- deferred: a block clips its next tile before it looks back for the one
  before (persistent blocks, one staged tile), so the wait overlaps a clip.
Prints each schedule's total time, and the two look-back schedules' ratio
to `free`, for several spreads.  A model, run on the CPU: it says how the
wait scales, not what the card does.
"""

from __future__ import annotations

import argparse
import heapq

import numpy as np


def free(times, w):
    heap = [0.0] * w
    for t in times:
        heapq.heappush(heap, heapq.heappop(heap) + t)
    return max(heap)


def immediate(times, w):
    heap = [0.0] * w
    done = end = 0.0
    for t in times:
        done = max(done, heapq.heappop(heap) + t)  # every earlier tile is done
        heapq.heappush(heap, done)
        end = max(end, done)
    return end


def deferred(times, w):
    """Each block publishes a tile when it is clipped and resolves its
    previous tile after the next clip, once every earlier tile is done."""
    heap = [(0.0, i, -1) for i in range(w)]
    published = np.zeros(len(times))
    before = np.zeros(len(times) + 1)  # before[k]: every tile < k published
    end = 0.0
    for k, t in enumerate(times):
        start, block, prev = heapq.heappop(heap)
        published[k] = start + t
        before[k + 1] = max(before[k], published[k])
        ready = published[k] if prev < 0 else max(published[k], before[prev])
        heapq.heappush(heap, (ready, block, k))
        end = max(end, ready)
    for ready, _, prev in heap:
        if prev >= 0:
            end = max(end, ready, before[prev])
    return end


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=528,
                    help="resident blocks (132 SMs x 4 on an H100)")
    ap.add_argument("--tiles", type=int, default=65536,
                    help="tiles (8 passes of 2^21 slots, 256 a tile)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    for sigma in (0.1, 0.3, 0.5):
        times = rng.lognormal(0.0, sigma, args.tiles)
        base = free(times, args.blocks)
        now = immediate(times, args.blocks)
        later = deferred(times, args.blocks)
        print(f"sigma {sigma}: free {base:.1f}, immediate {now:.1f} "
              f"({now / base:.3f}x), deferred {later:.1f} ({later / base:.3f}x)")


if __name__ == "__main__":
    main()
