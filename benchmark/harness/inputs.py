"""The inputs of one run, drawn from --seed.  Each generator is a file of
its own, `benchmark/inputs/<kind>.py`, found by the "kind" that a traffic
mix's "inputs" object names, with a function

    make(params, resolution, rng, seed, device) -> Inputs

that reads the rest of "inputs" as its parameters.  `rng` is a numpy
Generator seeded with the run's seed; a generator that makes its meshes
on a device seeds a torch.Generator there with `seed` and uses `device`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Inputs:
    """The meshes of one run: each (verts (N, 3, 3) float32, rgb (N, 3)
    float32), on the host.  space "grid": in the configuration's voxel grid
    already; "model": in model space, for the program to place."""

    meshes: list
    space: str

    @property
    def triangles(self) -> int:
        return sum(v.shape[0] for v, _ in self.meshes)


def make(cell, seed: int, device="cpu") -> Inputs:
    """The inputs of one run of `cell` (spec.Cell) from its traffic mix's
    "inputs" and the run's seed."""
    return cell.generator.make(cell.traffic["inputs"], int(cell.config["resolution"]),
                               np.random.default_rng(seed), seed, torch.device(device))
