"""Global (slab x volume-bucket) pass planning for the streaming engine.

Round-2 redesign of the hot-path work schedule.  The round-1 engine gathered
one packed triangle row PER (triangle, voxel) PAIR inside the device tile loop;
measured on the TPU, that XLA gather runs at ~2 GB/s and was ~half of every
pass (probes/probe_r2.out: 133 ms per 2^21 rows, vs 2.3 ms for the clip math).

The fix is structural: gather per TRIANGLE, not per pair.  On the host we
compute, for every z-slab, the set of triangles overlapping it and each
triangle's slab-clamped AABB volume, bucket them by ceil-log2(volume), and
emit ONE global row order: all rows of (slab 0, k=0), then (slab 0, k=1), ...
then slab 1, and so on.  The device gathers the triangle table into that order
ONCE per mesh.  A pass over bucket k then reads a *contiguous* row range and
expands each row into exactly 2^k pair slots -- with k static per pass, the
expansion is a plain XLA broadcast+reshape (pure data movement), and the
within-AABB rank is `iota & (2^k - 1)`.  No gather, no searchsorted, nothing
data-dependent on the pair axis.

This plays the same work-regularizer role as the reference's subdivision limit
(reference src/voxelization.cpp:349-379 bounds per-triangle AABB volume to
SUBDIVISION_VOLUME_LIMIT=512): bounded, shape-static per-triangle work.  The
pow2 rounding wastes at most 2x pair slots; dead slots clip to zero weight and
vanish in the combine.

Triangles spanning multiple slabs appear once per slab they touch (the
reference re-voxelizes such triangles per chunk, clipped to chunk bounds --
src/voxelization.cpp:440-444 -- with the same duplication property).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .expand_bucket import plan_adaptive_slabs

__all__ = ["Segment", "plan_mesh", "plan_adaptive_slabs"]


@dataclasses.dataclass(frozen=True)
class Segment:
    """One (slab, bucket) run of rows in the globally sorted triangle order.

    Rows [r0, r1) all belong to z-slab [z_lo, z_hi) and own 2^k pair slots
    each; total slot count is (r1 - r0) << k.
    """

    z_lo: int
    z_hi: int
    k: int
    r0: int
    r1: int

    @property
    def rows(self) -> int:
        return self.r1 - self.r0

    @property
    def slots(self) -> int:
        return self.rows << self.k


def _ceil_log2(counts: np.ndarray) -> np.ndarray:
    """Exact ceil(log2(c)) for int64 c >= 1 (float-log edge cases corrected)."""
    k = np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int32)
    too_small = (np.int64(1) << k.astype(np.int64)) < counts
    k[too_small] += 1
    too_big = (k > 0) & ((np.int64(1) << np.maximum(k - 1, 0).astype(np.int64)) >= counts)
    k[too_big] -= 1
    return k


def plan_mesh(vmin, vmax, stride, z_extent, slot_budget, align=2, z_window=None):
    """Plan the full pass schedule for one mesh.

    vmin/vmax: (N, 3) int64 per-triangle voxel AABBs, x/y clamped to the grid,
               z clamped to [0, z_extent] (vmax exclusive).
    stride:    grid resolution in x/y (sample resolution).
    z_extent:  grid extent in z (== stride except in batch mode).
    slot_budget: target pair-slot count per slab (adaptive slab heights).
    z_window:  optional (z0, z1), even-aligned: the slabs tile this range
               only (parallel/mesh.py, where each device streams a window).

    Returns (order, segments):
      order:    (M,) int32 triangle indices, the global gather order
                (duplicates for slab-spanning triangles), or None if empty.
      segments: list[Segment] in order-of-rows (grouped by slab, ascending k).
    """
    slabs = plan_adaptive_slabs(vmin, vmax, stride, z_extent, slot_budget, align,
                                z_window)

    if not slabs:
        return None, []

    # one global sort over all (triangle, slab) incidences instead of a
    # per-slab argsort loop (the loop cost ~1 s at 2M triangles on one core)
    n_slabs = len(slabs)
    starts = np.fromiter((s[0] for s in slabs), np.int64, n_slabs)
    stops = np.fromiter((s[1] for s in slabs), np.int64, n_slabs)

    sx = vmax[:, 0] - vmin[:, 0]
    sy = vmax[:, 1] - vmin[:, 1]
    live = (sx > 0) & (sy > 0) & (vmax[:, 2] > vmin[:, 2])
    live &= (vmax[:, 2] > starts[0]) & (vmin[:, 2] < stops[-1])
    tri = np.nonzero(live)[0].astype(np.int32)
    if tri.size == 0:
        return None, []

    # slab index range [s_first, s_last] per live triangle (slabs contiguous)
    s_first = np.clip(
        np.searchsorted(starts, vmin[tri, 2], side="right") - 1, 0, n_slabs - 1
    )
    s_last = np.clip(
        np.searchsorted(starts, vmax[tri, 2] - 1, side="right") - 1, 0, n_slabs - 1
    )
    rep = (s_last - s_first + 1).astype(np.int64)

    idx = np.repeat(tri, rep)
    # intra-run rank -> slab id per incidence
    m = idx.size
    run_starts = np.zeros(m, np.int64)
    cum = np.cumsum(rep)[:-1]
    run_first = np.repeat(s_first, rep)
    rank = np.arange(m, dtype=np.int64)
    rank -= np.repeat(np.concatenate([[0], cum]), rep)
    slab_of = (run_first + rank).astype(np.int64)
    del run_starts

    z0 = np.maximum(vmin[idx, 2], starts[slab_of])
    z1 = np.minimum(vmax[idx, 2], stops[slab_of])
    # int64 product: callers may pass int32 AABBs (engine does, to halve the
    # 10M-triangle planning footprint)
    counts = sx[idx].astype(np.int64) * sy[idx] * (z1 - z0)
    k = _ceil_log2(counts)

    key = slab_of * 64 + k  # k < 40 always (counts < 2^31 per slab)
    sort = np.argsort(key, kind="stable")
    order = idx[sort].astype(np.int32)
    skey = key[sort]

    uniq, seg_starts = np.unique(skey, return_index=True)
    bounds = np.append(seg_starts, skey.size)
    segments = []
    for i, kk in enumerate(uniq):
        s = int(kk) // 64
        segments.append(
            Segment(
                int(starts[s]), int(stops[s]), int(kk) % 64,
                int(bounds[i]), int(bounds[i + 1]),
            )
        )
    return order, segments
