"""Inputs kind "sphere_set": "meshes" UV spheres (harness/meshes.py) in
model space, of the sizes that BASELINE config 5 draws (numpy
RandomState("size_seed"): randint over "triangles", mesh by mesh) and in
its order.  The seed scales each (uniform over "scale"), moves it (uniform
over +-"shift" on each axis) and colors each triangle (each channel
k / 255).  The program normalizes each mesh into its own grid, so every
seed has the same work, the stack the same schedule, and the float32
arithmetic other numbers."""

from __future__ import annotations

import numpy as np

from benchmark.harness.inputs import Inputs
from benchmark.harness.meshes import sphere


def make(params, resolution, rng, seed, device) -> Inputs:
    draw = np.random.RandomState(int(params["size_seed"]))
    lo, hi = params["triangles"]
    s_lo, s_hi = params["scale"]
    reach = float(params["shift"])
    meshes = []
    for _ in range(int(params["meshes"])):
        n = int(draw.randint(lo, hi))
        draw.uniform(s_lo, s_hi)  # config 5's own scale, drawn to keep its sizes
        scale = np.float32(rng.uniform(s_lo, s_hi))
        shift = rng.uniform(-reach, reach, 3).astype(np.float32)
        verts = sphere(n).numpy() * scale + shift
        k = rng.integers(0, 256, (verts.shape[0], 3), dtype=np.uint8)
        meshes.append((verts, k.astype(np.float32) / np.float32(255)))
    return Inputs(meshes, "model")
