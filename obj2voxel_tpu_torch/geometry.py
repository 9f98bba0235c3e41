"""Mesh-space -> voxel-grid-space transform math (host-side, float32 numpy).

Reproduces the reference's AffineTransform composition semantics
(reference: src/util.hpp:212-281, src/obj2voxel.cpp:370-402) and the CLI's
permutation parsing (reference: src/main.cpp:224-262).  All arithmetic is
float32 to match the reference's `real_type = float`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import ANTI_BLEED


@dataclasses.dataclass
class AffineTransform:
    """3x3 matrix + translation, composed exactly like the reference's struct."""

    matrix: np.ndarray  # (3, 3) float32
    translation: np.ndarray  # (3,) float32

    @staticmethod
    def scale_translate(scale: float, translation=(0.0, 0.0, 0.0)) -> "AffineTransform":
        return AffineTransform(
            np.eye(3, dtype=np.float32) * np.float32(scale),
            np.asarray(translation, dtype=np.float32),
        )

    @staticmethod
    def from_unit_transform(matrix9, translation=(0.0, 0.0, 0.0)) -> "AffineTransform":
        m = np.asarray(matrix9, dtype=np.float32).reshape(3, 3)
        return AffineTransform(m, np.asarray(translation, dtype=np.float32))

    def compose(self, rhs: "AffineTransform") -> "AffineTransform":
        """self * rhs, applied as self(rhs(v)) (reference util.hpp:270-281)."""
        m = (self.matrix.astype(np.float32) @ rhs.matrix.astype(np.float32)).astype(np.float32)
        t = (self.matrix @ rhs.translation + self.translation).astype(np.float32)
        return AffineTransform(m, t)

    def apply(self, points: np.ndarray) -> np.ndarray:
        """Apply to an (..., 3) array of float32 points."""
        p = np.asarray(points, dtype=np.float32)
        return (p @ self.matrix.T.astype(np.float32) + self.translation).astype(np.float32)


def compute_mesh_transform(
    mesh_min, mesh_max, sample_resolution: int, unit_transform=None
) -> AffineTransform:
    """Model space -> voxel grid space transform (reference obj2voxel.cpp:370-402).

    Chain: translate to positive octant, scale to [-1, 1] unit cube, apply the
    user's axis permutation/flip, then scale to [ANTI_BLEED/2, r - ANTI_BLEED/2].
    """
    mesh_min = np.asarray(mesh_min, dtype=np.float32)
    mesh_max = np.asarray(mesh_max, dtype=np.float32)
    mesh_size = mesh_max - mesh_min
    max_of_all_axes = np.float32(mesh_size.max())
    sample_scale = np.float32(sample_resolution) - np.float32(ANTI_BLEED)

    if unit_transform is None:
        unit_transform = (1, 0, 0, 0, 1, 0, 0, 0, 1)

    result = AffineTransform.scale_translate(1.0, -mesh_min)
    result = AffineTransform.scale_translate(
        np.float32(2.0) / max_of_all_axes, (-1.0, -1.0, -1.0)
    ).compose(result)
    result = AffineTransform.from_unit_transform(unit_transform, (1.0, 1.0, 1.0)).compose(result)
    result = AffineTransform.scale_translate(
        sample_scale / np.float32(2.0), np.full(3, ANTI_BLEED / 2.0, dtype=np.float32)
    ).compose(result)
    return result


def parse_permutation(perm: str):
    """Parse an axis permutation like "xYz" into a 9-int row-major unit matrix.

    Capital letters flip the axis (reference main.cpp:224-262).  Raises
    ValueError on invalid input (the CLI maps that to exit code 1).
    """
    if len(perm) != 3:
        raise ValueError(f"Invalid permutation length ({len(perm)})")
    out = [0] * 9
    found = [False, False, False]
    for i, ch in enumerate(perm):
        negative = ch.isupper()
        c = ch.lower()
        axis = ord(c) - ord("x")
        if not 0 <= axis <= 2:
            raise ValueError(f"Invalid permutation char: '{ch}'")
        found[axis] = True
        out[i * 3 + axis] = -1 if negative else 1
    if not all(found):
        raise ValueError(f'Invalid combination of permutation chars "{perm}"')
    return out


def mesh_bounds(vertices: np.ndarray):
    """(min, max) over an (N, 3, 3) or (M, 3) float32 vertex array."""
    v = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    if v.size == 0:
        inf = np.float32(np.inf)
        return np.full(3, inf, np.float32), np.full(3, -inf, np.float32)
    return v.min(axis=0), v.max(axis=0)
