"""Procedural test meshes.

`make_sphere_mesh` is bench.py's UV sphere, kept here so that the port's
smoke test and scripts depend on nothing of the JAX side; its triangles are
bit-identical to bench.py's.  With `uvs=True` it also returns per-vertex
spherical UVs, u = longitude / 2 pi and v = 1 - latitude / pi, taken from
the same grid.
"""

from __future__ import annotations

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
