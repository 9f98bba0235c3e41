"""Per-voxel combine: stable key sort + segmented reduce + compaction.

The port of obj2voxel_tpu/ops/combine.py.  Values are premultiplied and
channel-major: a `chans` tuple of four (P,) float32 tensors (w, w*r, w*g,
w*b).  BLEND sums a run's channels and divides once at the end; MAX keeps
the entry with the strictly greater weight, the earlier entry winning ties,
so every sort here is stable.

`combine_sorted` is the plain segmented combine: `combine_pack`'s plain
version (ops/combine_pallas.py), K2's followed by K3's.  The engine's merges
call the `combine_pack` wrapper instead, which launches the CUDA kernel for
CUDA tensors.
"""

from __future__ import annotations

import torch

from ._cuda import INVALID_KEY
from .combine_pallas import combine_pack_ref

__all__ = ["INVALID_KEY", "combine_sorted", "downscale_keys", "finalize_colors",
           "pack_argb", "premultiply", "sort_channels"]


def premultiply(weight, rgb):
    """(w (P,), rgb (P, 3)) -> channel tuple (w, w*r, w*g, w*b)."""
    return (weight, weight * rgb[:, 0], weight * rgb[:, 1], weight * rgb[:, 2])


def sort_channels(keys, chans):
    """Stable sort of the four channels by int32 keys."""
    sk, idx = torch.sort(keys, stable=True)
    return sk, tuple(c[idx] for c in chans)


def combine_sorted(sorted_keys, chans, is_blend):
    """Combine a key-sorted premultiplied stream into unique rows.

    Returns (keys (P,), chans 4-tuple, count (1,) int32): the first `count`
    rows are the unique combined voxels in key order; the rest is
    (INVALID_KEY, 0)."""
    return combine_pack_ref(sorted_keys, chans, is_blend)


def downscale_keys(keys, stride):
    """2x2x2 downscale of slab-local keys x + stride*y + stride^2*z_local:
    each axis coordinate is halved and the key re-packed with stride // 2
    (slab z offsets are even, so z_local // 2 stays slab-local); INVALID
    keys pass through (obj2voxel_tpu/ops/combine.py:221-234)."""
    s2 = stride // 2
    k = keys.to(torch.int64)
    x = k % stride
    y = (k // stride) % stride
    zl = k // (stride * stride)
    down = ((zl // 2) * (s2 * s2) + (y // 2) * s2 + x // 2).to(torch.int32)
    return torch.where(keys == INVALID_KEY, keys, down)


def _exact_div(num, den):
    """num / den with one residual correction (combine.py:237-244); on an
    IEEE divide the correction is zero, and it keeps the port's bytes equal
    to the JAX package's on every backend."""
    q = num / den
    return q + (num - q * den) / den


def finalize_colors(chans):
    """Premultiplied channels -> (r, g, b) float tuple in [0, 1]."""
    w = chans[0]
    safe = torch.where(w > 0, w, torch.ones_like(w))
    return tuple(_exact_div(c, safe) for c in chans[1:4])


def pack_argb(rgb_chans):
    """(r, g, b) float channel tuple in [0, 1] -> (P,) ARGB with a = 255, as
    a uint32 tensor."""
    q = [
        torch.clamp(torch.round(c * 255.0), 0, 255).to(torch.int64)
        for c in rgb_chans
    ]
    argb = 0xFF000000 | (q[0] << 16) | (q[1] << 8) | q[2]
    # every value has its top bit set: shift into int32 range, then
    # reinterpret the bits as uint32
    return (argb - (1 << 32)).to(torch.int32).view(torch.uint32)
