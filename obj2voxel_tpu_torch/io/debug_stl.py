"""Debug STL dump of processed (subdivided, transformed) triangles.

Rebuilds the reference's geometric-debugging subsystem (reference:
src/io.hpp:16-21, src/io.cpp:30-59, hook at voxelization.cpp:497-499): the
engine can tee every triangle it actually voxelizes into an in-memory binary
STL for inspection in a mesh viewer.  Enabled via `O2V_DUMP_STL=<path>` in the
CLI or by calling `enable(path)` programmatically.
"""

from __future__ import annotations

import struct

import numpy as np

_dump_path: str | None = None
_buffers: list[np.ndarray] = []


def enable(path: str):
    global _dump_path
    _dump_path = path
    _buffers.clear()


def enabled() -> bool:
    return _dump_path is not None


def record(verts: np.ndarray):
    """Record an (N, 3, 3) float32 triangle batch."""
    if _dump_path is not None and verts.size:
        _buffers.append(np.asarray(verts, np.float32).copy())


def flush():
    """Write the recorded triangles as binary little-endian STL."""
    global _dump_path
    if _dump_path is None:
        return
    tris = np.concatenate(_buffers) if _buffers else np.zeros((0, 3, 3), np.float32)
    n = tris.shape[0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    normals = np.cross(e1, e2)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.where(lens > 0, lens, 1.0)

    record_dt = np.dtype(
        [("n", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")]
    )
    out = np.zeros(n, record_dt)
    out["n"] = normals
    out["v"] = tris
    with open(_dump_path, "wb") as f:
        f.write(b"\x00" * 80)
        f.write(struct.pack("<I", n))
        f.write(out.tobytes())
    _dump_path = None
    _buffers.clear()
