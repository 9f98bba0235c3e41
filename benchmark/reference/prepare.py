"""The plain reference's host steps, in numpy: a mesh's transform into its
voxel grid and the subdivision of large diagonal triangles.

These follow obj2voxel's own steps (reference src/obj2voxel.cpp:370-402,
src/voxelization.cpp:335-379, src/triangle.hpp:91-143) in float32, as the
program must, and are written out again here rather than imported: the
reference takes nothing that the program made or computes.
"""

from __future__ import annotations

import numpy as np

#: Shrink of the grid so that geometry never lies on its outer faces
#: (reference src/obj2voxel.cpp:372).
ANTI_BLEED = 0.5

#: Triangles whose voxel AABB holds this many voxels or more are split
#: (reference src/constants.hpp:13).
SUBDIVISION_VOLUME_LIMIT = 512

#: Triangles this close to an axis plane are never split (reference
#: COS_SUBDIVISION_DIAGONALITY_LIMIT).
DIAGONALITY_LIMIT = 0.5

_SQRT_THIRD = 0.5773502691896258


def _affine(matrix, translation):
    return (np.asarray(matrix, np.float32), np.asarray(translation, np.float32))


def _compose(lhs, rhs):
    """lhs after rhs, in float32 (reference src/util.hpp:270-281)."""
    m = (lhs[0] @ rhs[0]).astype(np.float32)
    t = (lhs[0] @ rhs[1] + lhs[1]).astype(np.float32)
    return m, t


def grid_transform(verts: np.ndarray, resolution: int):
    """The model-to-grid transform of a mesh: its bounds to the positive
    octant, the longest side to [-1, 1], then to [ANTI_BLEED / 2,
    resolution - ANTI_BLEED / 2]."""
    v = verts.reshape(-1, 3)
    lo, hi = v.min(axis=0), v.max(axis=0)
    longest = np.float32((hi - lo).max())
    scale = np.float32(resolution) - np.float32(ANTI_BLEED)
    eye = np.eye(3, dtype=np.float32)
    t = _affine(eye, -lo)
    t = _compose(_affine(eye * (np.float32(2.0) / longest), (-1.0, -1.0, -1.0)), t)
    t = _compose(_affine(eye, (1.0, 1.0, 1.0)), t)
    t = _compose(_affine(eye * (scale / np.float32(2.0)),
                         np.full(3, ANTI_BLEED / 2.0, np.float32)), t)
    return t


def to_grid(verts: np.ndarray, resolution: int) -> np.ndarray:
    """(N, 3, 3) model-space triangles in their mesh's voxel grid."""
    m, t = grid_transform(verts, resolution)
    return (verts.astype(np.float32) @ m.T + t).astype(np.float32)


def _aabb_volume(verts):
    size = np.maximum(np.floor(verts.max(axis=1)) + 1.0 - np.floor(verts.min(axis=1)), 0.0)
    return size[:, 0] * size[:, 1] * size[:, 2]


def _axis_aligned(verts):
    n = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    norm = np.linalg.norm(n, axis=1)
    n = np.abs(n) / np.where(norm > 0, norm, 1.0)[:, None]
    diagonality = (n.sum(axis=1) * _SQRT_THIRD - _SQRT_THIRD) / (1.0 - _SQRT_THIRD)
    return diagonality < DIAGONALITY_LIMIT


def subdivide(verts: np.ndarray):
    """Split every triangle that is not roughly axis-aligned into four at
    its edge midpoints until its voxel AABB holds fewer than
    SUBDIVISION_VOLUME_LIMIT voxels.  Returns the triangles and, for each,
    the index of the input triangle it came from."""
    index = np.arange(verts.shape[0], dtype=np.int64)
    aligned = _axis_aligned(verts)
    done_v, done_i = [], []
    while verts.shape[0]:
        split = ~aligned & (_aabb_volume(verts) >= SUBDIVISION_VOLUME_LIMIT)
        done_v.append(verts[~split])
        done_i.append(index[~split])
        if not split.any():
            break
        v, index = verts[split], index[split]
        mid = np.stack([0.5 * (v[:, 0] + v[:, 1]), 0.5 * (v[:, 1] + v[:, 2]),
                        0.5 * (v[:, 2] + v[:, 0])], axis=1).astype(np.float32)
        verts = np.concatenate([
            mid,
            np.stack([v[:, 0], mid[:, 0], mid[:, 2]], axis=1),
            np.stack([v[:, 1], mid[:, 1], mid[:, 0]], axis=1),
            np.stack([v[:, 2], mid[:, 2], mid[:, 1]], axis=1),
        ])
        index = np.concatenate([index] * 4)
        aligned = np.zeros(verts.shape[0], dtype=bool)
    return np.concatenate(done_v), np.concatenate(done_i)
