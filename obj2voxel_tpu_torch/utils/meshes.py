"""Procedural test meshes and a binary STL writer.

`make_sphere_mesh` is bench.py's UV sphere, `make_helix_mesh` and
`write_stl` are scripts/scale_proof.py's helix tube and STL writer, kept
here so that the port's bench, scale runs, smoke test and scripts depend on
nothing of the JAX side; their triangles and bytes are bit-identical to
the originals'.  With `uvs=True` the sphere also comes with per-vertex
spherical UVs, u = longitude / 2 pi and v = 1 - latitude / pi, taken from
the same grid.
"""

from __future__ import annotations

import struct

import numpy as np


def _grid_triangles(grid: np.ndarray) -> np.ndarray:
    """(n_lat + 1, n_lon + 1, C) vertex grid -> (2 n_lat n_lon, 3, C)
    triangles, two per grid cell, in bench.py's order."""
    a = grid[:-1, :-1]
    b = grid[1:, :-1]
    c = grid[1:, 1:]
    d = grid[:-1, 1:]
    ch = grid.shape[-1]
    t1 = np.stack([a, b, c], axis=2).reshape(-1, 3, ch)
    t2 = np.stack([a, c, d], axis=2).reshape(-1, 3, ch)
    return np.concatenate([t1, t2]).astype(np.float32)


def make_sphere_mesh(n_tris: int, uvs: bool = False):
    """Procedural UV-sphere triangle soup with ~n_tris triangles (unit
    radius): (N, 3, 3) float32, and with uvs=True also (N, 3, 2) float32."""
    n_lat = max(8, int(np.sqrt(n_tris / 2)))
    n_lon = max(8, n_tris // (2 * n_lat))
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon + 1)
    theta, phi = np.meshgrid(lat, lon, indexing="ij")
    pts = np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)],
        axis=-1,
    ).astype(np.float32)
    tris = _grid_triangles(pts)
    if not uvs:
        return tris
    uv = np.stack([phi / (2 * np.pi), 1.0 - theta / np.pi], axis=-1).astype(np.float32)
    return tris, _grid_triangles(uv)


def make_helix_mesh(n_tris: int, turns: float = 3.0, tube_r: float = 0.002):
    """Triangulated helix tube spanning [0,1]^3 with a small surface area:
    the voxel count grows O(r), not O(r^2), while every z-slab of the grid
    carries geometry (BASELINE config 6's mesh).  (N, 3, 3) float32."""
    sides = 6
    n_seg = max(n_tris // (2 * sides), 8)
    t = np.linspace(0.0, 1.0, n_seg + 1)
    ang = 2 * np.pi * turns * t
    cx = 0.5 + 0.45 * np.cos(ang)
    cy = 0.5 + 0.45 * np.sin(ang)
    cz = t
    center = np.stack([cx, cy, cz], axis=1)
    # local frame: tangent x up -> two normals
    tang = np.gradient(center, axis=0)
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    up = np.array([0.0, 0.0, 1.0])
    n1 = np.cross(tang, up)
    n1 /= np.maximum(np.linalg.norm(n1, axis=1, keepdims=True), 1e-9)
    n2 = np.cross(tang, n1)
    phi = 2 * np.pi * np.arange(sides) / sides
    ring = (
        center[:, None, :]
        + tube_r * np.cos(phi)[None, :, None] * n1[:, None, :]
        + tube_r * np.sin(phi)[None, :, None] * n2[:, None, :]
    )  # (n_seg+1, sides, 3)
    a = ring[:-1]
    b = ring[1:]
    a2 = np.roll(a, -1, axis=1)
    b2 = np.roll(b, -1, axis=1)
    return np.concatenate(
        [
            np.stack([a, b, a2], axis=2).reshape(-1, 3, 3),
            np.stack([a2, b, b2], axis=2).reshape(-1, 3, 3),
        ]
    ).astype(np.float32)


def write_stl(path: str, tris: np.ndarray):
    """Write (N, 3, 3) triangles as a little-endian binary STL: a zero
    header, zero normals and zero attribute words (scripts/scale_proof.py's
    bytes)."""
    n = tris.shape[0]
    rec = np.zeros(n, dtype=np.dtype([("n", "<f4", 3), ("v", "<f4", (3, 3)), ("a", "<u2")]))
    rec["v"] = tris
    with open(path, "wb") as f:
        f.write(b"\x00" * 80)
        f.write(struct.pack("<I", n))
        rec.tofile(f)  # no second copy of a 500 MB table
