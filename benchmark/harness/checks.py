"""The comparison that decides `correct`.

The window's kept outputs are held against the plain reference's, run on
the same inputs once the window has closed.  Numbers compared, each with
its limit:

  voxels_differ    the most voxels by which one conversion's kept outputs
                   and the reference's differ (in one and not the other,
                   or twice in one); limit 0: the configurations state
                   exact occupancy
  color_lsb        the widest gap, in units of the last place of one 8-bit
                   channel, between a kept voxel's ARGB and the
                   reference's, over the voxels that are not tied (MAX:
                   the heaviest weight shared by triangles of different
                   colors, which the program breaks by its pass order);
                   limit: the configuration's "color_lsb" (MAX colors
                   byte-exact, BLEND within 1)
  conversions_off  conversions of the window whose kept outputs break one
                   of the two limits above, or whose digest of every
                   output voxel differs from the digest of the conversion
                   that was kept whole; limit 0
"""

from __future__ import annotations

import numpy as np


def channel_gap(a: np.ndarray, b: np.ndarray) -> int:
    """The widest gap between two ARGB arrays over their four 8-bit
    channels."""
    if a.size == 0:
        return 0
    a = a.astype(np.int64)
    b = b.astype(np.int64)
    return int(max(np.abs(((a >> s) & 255) - ((b >> s) & 255)).max() for s in (0, 8, 16, 24)))


def compare_unit(keys, argb, ref_keys, ref_argb, ref_tied):
    """(voxels that differ, widest channel gap over the shared voxels that
    are not tied, tied voxels left out) of one unit's outputs against the
    reference's; ref_keys ascend and are unique."""
    order = np.argsort(keys, kind="stable")
    keys, argb = keys[order], argb[order]
    uniq, first = np.unique(keys, return_index=True)
    twice = keys.shape[0] - uniq.shape[0]
    shared, in_prog, in_ref = np.intersect1d(uniq, ref_keys, assume_unique=True,
                                             return_indices=True)
    differ = twice + uniq.shape[0] + ref_keys.shape[0] - 2 * shared.shape[0]
    judged = ~ref_tied[in_ref]
    return (int(differ),
            channel_gap(argb[first[in_prog]][judged], ref_argb[in_ref][judged]),
            int((~judged).sum()))


def judge(conversions, unit_arrays, reference, color_limit: int):
    """The compared numbers of a window: {name: (value, limit)}, and the
    conversions that are off.  `unit_arrays` turns a kept unit into
    (keys, argb) numpy arrays; `reference` maps a unit's index to its
    reference (keys, argb, tied).  Also returns the tied voxels left out of
    the color comparison."""
    if not conversions[0].units:
        raise RuntimeError("benchmark: the window's first conversion kept nothing")
    digests = [None if c.digest is None else int(c.digest) for c in conversions]
    worst_differ, worst_gap, off, tied = 0, 0, 0, 0
    for c, digest in zip(conversions, digests):
        differ = gap = 0
        for u, out in c.units.items():
            d, g, t = compare_unit(*unit_arrays(out), *reference[u])
            differ += d
            gap = max(gap, g)
            if c is conversions[0]:
                tied += t
        bad = differ > 0 or gap > color_limit or digest != digests[0]
        worst_differ = max(worst_differ, differ)
        worst_gap = max(worst_gap, gap)
        off += int(bad)
    return ({"voxels_differ": (worst_differ, 0), "color_lsb": (worst_gap, color_limit),
             "conversions_off": (off, 0)}, off, tied)


def passed(checks: dict) -> bool:
    return all(value <= limit for value, limit in checks.values())
