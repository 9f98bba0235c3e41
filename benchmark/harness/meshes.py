"""The UV sphere that the benchmark's traffic draws, frozen here so that
no later change to the program's own generator moves the yardstick.

Its grid and triangle order are those of the repository's bench.py sphere
(`make_sphere_mesh`): (n_lat + 1) x (n_lon + 1) vertices on latitude and
longitude lines, two triangles a cell: every cell's (a, b, c) triangle,
then every cell's (a, c, d).  It is made with torch on the device it is
asked for, so that a big sphere is made on the card in a few large calls.
"""

from __future__ import annotations

import numpy as np
import torch


def sphere(n_tris: int, device="cpu") -> torch.Tensor:
    """(N, 3, 3) float32 triangles of the unit UV sphere of about n_tris
    triangles, on `device`."""
    n_lat = max(8, int(np.sqrt(n_tris / 2)))
    n_lon = max(8, n_tris // (2 * n_lat))
    f64 = dict(dtype=torch.float64, device=device)
    theta, phi = torch.meshgrid(torch.linspace(0, np.pi, n_lat + 1, **f64),
                                torch.linspace(0, 2 * np.pi, n_lon + 1, **f64),
                                indexing="ij")
    grid = torch.stack([torch.sin(theta) * torch.cos(phi),
                        torch.sin(theta) * torch.sin(phi), torch.cos(theta)],
                       dim=-1).to(torch.float32)
    del theta, phi
    a, b, c, d = grid[:-1, :-1], grid[1:, :-1], grid[1:, 1:], grid[:-1, 1:]
    return torch.cat([torch.stack([a, b, c], dim=2).reshape(-1, 3, 3),
                      torch.stack([a, c, d], dim=2).reshape(-1, 3, 3)])
