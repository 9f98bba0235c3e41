"""Inputs kind "sphere_in_grid": one UV sphere (harness/meshes.py) of
about "triangles" triangles, made on the run's device, centred in the
configuration's voxel grid and scaled to fill it less the grid's
anti-bleed shrink, then handed to the host, where the port's table and
the reference take their inputs.

The seed draws one of the eight rotations that map the grid onto itself
(a quarter turn about z, times a half turn about x, by exact swaps and
negations), a cyclic shift of the triangles' order, and each triangle's
color (each channel k / 255).  So every seed has the same triangles and
the same work, in another order and orientation.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness.inputs import Inputs
from benchmark.harness.meshes import sphere

#: The grid's shrink on each side (reference src/obj2voxel.cpp:372).
ANTI_BLEED = 0.5


def make(params, resolution, rng, seed, device) -> Inputs:
    tris = sphere(int(params["triangles"]), device)
    turn = int(rng.integers(0, 8))
    x, y, z = tris.unbind(-1)
    for _ in range(turn % 4):
        x, y = -y, x
    if turn >= 4:
        y, z = -y, -z
    tris = torch.roll(torch.stack([x, y, z], dim=-1), int(rng.integers(0, tris.shape[0])), 0)
    del x, y, z
    scale = float(np.float32((resolution - ANTI_BLEED) / 2.0))
    verts = ((tris + 1.0) * scale + ANTI_BLEED / 2.0).cpu().numpy()
    del tris
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    k = torch.randint(0, 256, (verts.shape[0], 3), generator=gen, device=device,
                      dtype=torch.int32)
    return Inputs([(verts, (k.to(torch.float32) / 255.0).cpu().numpy())], "grid")
