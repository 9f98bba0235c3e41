"""Host-side triangle subdivision (work regularizer).

Reimplements the reference's subdivision pass (reference:
src/voxelization.cpp:335-379, src/triangle.hpp:134-143) as vectorized numpy
rounds: triangles that are not roughly axis-aligned and whose voxel-AABB
volume reaches SUBDIVISION_VOLUME_LIMIT are Sierpinski-split (1 -> 4, edge
midpoints) until every piece is below the limit.  This bounds the number of
wasted (triangle, voxel) candidate pairs for large diagonal triangles, exactly
the role it plays in the reference.

Axis-alignedness is decided once per input triangle (subdivision preserves the
plane, hence the normal, hence the diagonality), matching the reference's
check on the input triangle only (voxelization.cpp:503-510).

Note one deliberate deviation recorded in SURVEY.md: the reference blends all
sub-triangle pieces of one input triangle at the UV level and then performs a
single voxel-level insert per input triangle; here each sub-triangle inserts
independently with its clipped area as weight.  Summed blend weights are
identical; MAX-strategy ties can resolve to a different piece of the same
triangle (finer-grained sampling of the same surface).
"""

from __future__ import annotations

import numpy as np

from ..constants import COS_SUBDIVISION_DIAGONALITY_LIMIT, SUBDIVISION_VOLUME_LIMIT

_SQRT_THIRD = 0.5773502691896258


def _aabb_volume(verts: np.ndarray) -> np.ndarray:
    """Voxel-AABB volume per triangle, matching voxelMin/voxelMax semantics
    (floor(min), floor(max)+1 exclusive; reference triangle.hpp:91-100)."""
    vmin = np.floor(verts.min(axis=1))
    vmax = np.floor(verts.max(axis=1)) + 1.0
    size = np.maximum(vmax - vmin, 0.0)
    return size[:, 0] * size[:, 1] * size[:, 2]


def roughly_axis_aligned(verts: np.ndarray) -> np.ndarray:
    """Per-triangle axis-alignedness test (reference voxelization.cpp:335-347)."""
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=1)
    norm = np.where(norm > 0, norm, 1.0)
    n = np.abs(n) / norm[:, None]
    diagonality = n.sum(axis=1) * _SQRT_THIRD
    diagonality01 = (diagonality - _SQRT_THIRD) / (1.0 - _SQRT_THIRD)
    return diagonality01 < COS_SUBDIVISION_DIAGONALITY_LIMIT


def subdivide_soup(
    verts: np.ndarray,
    uvs: np.ndarray,
    tri_index: np.ndarray | None = None,
    volume_limit: int = SUBDIVISION_VOLUME_LIMIT,
    max_rounds: int = 24,
):
    """Subdivide oversized non-axis-aligned triangles.

    verts: (N, 3, 3) float32 in voxel-grid space; uvs: (N, 3, 2).
    tri_index: optional (N,) mapping to original triangle ids (for material
    lookups); identity if None.

    Returns (verts', uvs', tri_index') with every non-aligned triangle's
    AABB volume < volume_limit.
    """
    n = verts.shape[0]
    if tri_index is None:
        tri_index = np.arange(n, dtype=np.int64)
    if n == 0:
        return verts, uvs, tri_index

    aligned = roughly_axis_aligned(verts)

    done_v, done_u, done_i = [], [], []
    work_v, work_u, work_i = verts, uvs, tri_index
    work_aligned = aligned

    for _ in range(max_rounds):
        if work_v.shape[0] == 0:
            break
        vol = _aabb_volume(work_v)
        split = (~work_aligned) & (vol >= volume_limit)
        if not split.any():
            break
        keep = ~split
        done_v.append(work_v[keep])
        done_u.append(work_u[keep])
        done_i.append(work_i[keep])

        sv = work_v[split]
        su = work_u[split]
        si = work_i[split]
        # edge midpoints (reference triangle.hpp:134-143)
        gv = np.stack(
            [
                0.5 * (sv[:, 0] + sv[:, 1]),
                0.5 * (sv[:, 1] + sv[:, 2]),
                0.5 * (sv[:, 2] + sv[:, 0]),
            ],
            axis=1,
        ).astype(verts.dtype)
        gu = np.stack(
            [
                0.5 * (su[:, 0] + su[:, 1]),
                0.5 * (su[:, 1] + su[:, 2]),
                0.5 * (su[:, 2] + su[:, 0]),
            ],
            axis=1,
        ).astype(uvs.dtype)

        pieces_v = [
            gv,  # center
            np.stack([sv[:, 0], gv[:, 0], gv[:, 2]], axis=1),
            np.stack([sv[:, 1], gv[:, 1], gv[:, 0]], axis=1),
            np.stack([sv[:, 2], gv[:, 2], gv[:, 1]], axis=1),
        ]
        pieces_u = [
            gu,
            np.stack([su[:, 0], gu[:, 0], gu[:, 2]], axis=1),
            np.stack([su[:, 1], gu[:, 1], gu[:, 0]], axis=1),
            np.stack([su[:, 2], gu[:, 2], gu[:, 1]], axis=1),
        ]
        work_v = np.concatenate(pieces_v)
        work_u = np.concatenate(pieces_u)
        work_i = np.concatenate([si] * 4)
        work_aligned = np.zeros(work_v.shape[0], dtype=bool)

    done_v.append(work_v)
    done_u.append(work_u)
    done_i.append(work_i)
    return (
        np.concatenate(done_v),
        np.concatenate(done_u),
        np.concatenate(done_i),
    )
