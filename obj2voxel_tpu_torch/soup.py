"""Host-side mesh containers and the packed triangle table.

`TriangleSoup` and `build_tri_table` are the JAX package's
(obj2voxel_tpu/engine.py:137-200, 979-1000) and `TexturePool` its
ops/color.py:21-53 registry, kept here torch-free so that host code can
build a table without importing the engine.  The (N, 24) float32 table
layout is byte-for-byte the JAX package's, so one numpy table feeds both
packages (`table_from_numpy`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import TRI_MATERIALLESS, UV_CLAMP


@dataclasses.dataclass
class TriangleSoup:
    """Flat triangle arrays, the device-friendly mesh representation."""

    verts: np.ndarray  # (N, 3, 3) float32
    uvs: np.ndarray  # (N, 3, 2) float32
    types: np.ndarray  # (N,) int32 (TRI_*)
    rgb: np.ndarray  # (N, 3) float32 flat colors (white for materialless)
    tex: np.ndarray  # (N,) int32 texture ids, -1 if none

    @staticmethod
    def empty() -> "TriangleSoup":
        return TriangleSoup(
            np.zeros((0, 3, 3), np.float32),
            np.zeros((0, 3, 2), np.float32),
            np.zeros((0,), np.int32),
            np.zeros((0, 3), np.float32),
            np.full((0,), -1, np.int32),
        )

    @staticmethod
    def from_vertices(verts: np.ndarray) -> "TriangleSoup":
        n = verts.shape[0]
        return TriangleSoup(
            np.asarray(verts, np.float32),
            np.zeros((n, 3, 2), np.float32),
            np.full((n,), TRI_MATERIALLESS, np.int32),
            np.ones((n, 3), np.float32),
            np.full((n,), -1, np.int32),
        )

    @staticmethod
    def from_simple_mesh(vertices, quads: bool = False) -> "TriangleSoup":
        """Raw (M*3,) or (M, 3) float vertex list of triangles or quads
        (reference ITriangleStream::fromSimpleMesh, io.cpp:82-116; quads split
        as (0,1,2) + (1,2,3) like the reference's strip-style emission)."""
        v = np.asarray(vertices, np.float32).reshape(-1, 3)
        per = 4 if quads else 3
        assert v.shape[0] % per == 0
        prims = v.reshape(-1, per, 3)
        if quads:
            tris = np.concatenate(
                [prims[:, [0, 1, 2]], prims[:, [0, 2, 3]]], axis=1
            ).reshape(-1, 3, 3)
        else:
            tris = prims
        return TriangleSoup.from_vertices(np.ascontiguousarray(tris))

    @staticmethod
    def from_indexed_mesh(vertices, elements, quads: bool = False) -> "TriangleSoup":
        """Indexed triangle/quad mesh (reference
        ITriangleStream::fromIndexedMesh, io.cpp:118-161)."""
        v = np.asarray(vertices, np.float32).reshape(-1, 3)
        e = np.asarray(elements, np.int64).reshape(-1, 4 if quads else 3)
        if quads:
            idx = np.concatenate([e[:, [0, 1, 2]], e[:, [0, 2, 3]]], axis=1).reshape(
                -1, 3
            )
        else:
            idx = e
        return TriangleSoup.from_vertices(np.ascontiguousarray(v[idx]))

    def __len__(self):
        return self.verts.shape[0]


class TexturePool:
    """Host-side registry packing all textures into one flat pixel pool."""

    def __init__(self):
        self._pixels = []
        self._meta = []
        self._offset = 0

    def add(self, argb: np.ndarray, wrap: int) -> int:
        """argb: (H, W) uint32 image. Returns the texture id."""
        h, w = argb.shape
        self._pixels.append(np.ascontiguousarray(argb.reshape(-1), dtype=np.uint32))
        self._meta.append((self._offset, w, h, wrap))
        self._offset += w * h
        return len(self._meta) - 1

    def set_wrap(self, tex_id: int, wrap: int):
        off, w, h, _ = self._meta[tex_id]
        self._meta[tex_id] = (off, w, h, wrap)

    def __len__(self):
        return len(self._meta)

    def device_arrays(self):
        if not self._meta:
            pixels = np.zeros(1, dtype=np.uint32)
            meta = np.zeros((1, 4), dtype=np.int32)
            meta[0] = (0, 1, 1, UV_CLAMP)
        else:
            pixels = np.concatenate(self._pixels)
            meta = np.asarray(self._meta, dtype=np.int32)
        return pixels, meta


def pow2_at_least(n: int, minimum: int = 256) -> int:
    """The rows a table of n triangles is padded to: a power of two."""
    p = minimum
    while p < n:
        p *= 2
    return p


def build_tri_table(verts, uvs, types, rgb, tex, n_pad: int | None = None) -> np.ndarray:
    """Pack per-triangle data into one (N, 24) float32 row table: [0:9]
    vertex coords, [9:15] UVs, [15] padding, [16] type, [17:20] rgb, [20]
    texture id (float-encoded; exact below 2^24), [21:24] padding.

    n_pad pads the table with zero rows in place."""
    n = verts.shape[0]
    if n_pad is not None and n_pad < n:
        raise ValueError(f"n_pad={n_pad} smaller than triangle count {n}")
    rows = n if n_pad is None else n_pad
    table = np.zeros((rows, 24), np.float32)
    table[:n, 0:9] = verts.reshape(n, 9)
    table[:n, 9:15] = uvs.reshape(n, 6)
    table[:n, 16] = types.astype(np.float32)
    table[:n, 17:20] = rgb
    table[:n, 20] = tex.astype(np.float32)
    return table


def table_from_numpy(table_np: np.ndarray, device):
    """The (N, 24) float32 numpy table as a contiguous tensor on `device`."""
    import torch

    table_np = np.ascontiguousarray(table_np, dtype=np.float32)
    if table_np.ndim != 2 or table_np.shape[1] != 24:
        raise ValueError(f"triangle table must be (N, 24), got {table_np.shape}")
    return torch.from_numpy(table_np).to(device)
