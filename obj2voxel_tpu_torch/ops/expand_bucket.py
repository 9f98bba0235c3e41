"""Bucketed (triangle, voxel) pair expansion.

Replaces the searchsorted-based `expand.expand_tile` on the hot path: a binary
search per pair costs ~18 dependent gathers (measured ~235 ms per 1M pairs on
TPU), while this scheme needs one small gather plus shifts/masks.

Idea: on the host, triangles overlapping a slab are grouped into buckets by
ceil-log2 of their slab-clamped AABB volume.  Within bucket k every triangle
owns exactly 2^k pair slots, so for a pair slot index `s` the triangle is
`idx[s >> k]` and the within-AABB rank is `s & (2^k - 1)` -- no search.  The
pow2 rounding wastes at most 2x pair slots, which the clip discards for free
(rank >= actual volume).  This is the role the reference's
SUBDIVISION_VOLUME_LIMIT plays as a work regularizer (voxelization.cpp:349-379)
re-expressed as static shape algebra.

Round 2 moved bucketing into the global planner (ops/plan.py); this module
keeps the slab-boundary estimators shared by the host and device planners.
"""

from __future__ import annotations

import numpy as np


def plan_adaptive_slabs(vmin, vmax, stride, z_extent, slot_budget, align=2,
                        z_window=None):
    """Choose z-slab boundaries so each slab's estimated pair-slot count fits
    `slot_budget` (single device pass per slab) while keys stay below int31.

    Estimates per-z-row slot counts with a difference-array histogram of
    sx*sy contributions (pow2 bucket rounding adds up to 2x, so callers
    should pass a budget with margin).  Boundaries are aligned to `align`
    (2 keeps supersampled downscale slab-local).  `z_window` is
    `slabs_from_rows`'s.
    """
    sx = np.maximum(vmax[:, 0] - vmin[:, 0], 0)
    sy = np.maximum(vmax[:, 1] - vmin[:, 1], 0)
    area = (sx * sy).astype(np.int64)
    z0 = np.clip(vmin[:, 2], 0, z_extent)
    z1 = np.clip(vmax[:, 2], 0, z_extent)
    diff = np.zeros(z_extent + 1, np.int64)
    np.add.at(diff, z0, area)
    np.add.at(diff, z1, -area)
    per_row = np.cumsum(diff[:-1])
    return slabs_from_rows(per_row, stride, z_extent, slot_budget, align,
                           z_window)


def slabs_from_rows(per_row, stride, z_extent, slot_budget, align=2,
                    z_window=None):
    """Slab boundaries from a per-z-row slot-count histogram (int or float;
    the device planner supplies f32 counts, exact enough for budgeting).
    With `z_window` = (z0, z1) the slabs tile [z0, z1) only (a multi-device
    window; z0 keeps the alignment), else [0, z_extent)."""
    max_h_keys = max(align, (2**31 - 2) // (stride * stride))

    slabs = []
    z, z_end = (0, z_extent) if z_window is None else z_window
    while z < z_end:
        acc = 0
        zh = z
        while zh < z_end and zh - z < max_h_keys:
            nxt = acc + int(per_row[zh])
            if zh > z and nxt > slot_budget:
                break
            acc = nxt
            zh += 1
        # align the boundary (never below z + align unless at the end)
        if zh < z_end:
            zh = max(z + align, zh - (zh - z) % align)
        slabs.append((z, min(zh, z_end)))
        z = slabs[-1][1]
    return slabs
