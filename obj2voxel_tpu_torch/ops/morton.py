"""Morton (Z-order) encoding and decoding.

The port of obj2voxel_tpu/ops/morton.py: voxelio's `ileave3`/`dileave3`
(reference src/util.hpp:185-195), which the reference uses for VoxelMap keys
and chunk ids.  The engine keys voxels linearly within a slab; Morton order
is a public utility.  Works on int64 torch tensors and on numpy integer
arrays (and Python ints), with the JAX module's bit order: x in the highest
interleaved lane.
"""

from __future__ import annotations

__all__ = ["ileave3", "dileave3"]


def _part3(x):
    """Spread the low 21 bits of x so there are two zero bits between each."""
    x = x & 0x1FFFFF
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def _unpart3(x):
    x = x & 0x1249249249249249
    x = (x | (x >> 2)) & 0x10C30C30C30C30C3
    x = (x | (x >> 4)) & 0x100F00F00F00F00F
    x = (x | (x >> 8)) & 0x1F0000FF0000FF
    x = (x | (x >> 16)) & 0x1F00000000FFFF
    x = (x | (x >> 32)) & 0x1FFFFF
    return x


def ileave3(x, y, z):
    """Interleave three 21-bit coordinates into a 63-bit Morton code."""
    return (_part3(x) << 2) | (_part3(y) << 1) | _part3(z)


def dileave3(code):
    """Inverse of ileave3; returns (x, y, z)."""
    return _unpart3(code >> 2), _unpart3(code >> 1), _unpart3(code)
