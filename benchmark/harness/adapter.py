"""What the entry adapters share.  Each adapter is a file of its own,
`benchmark/entries/<entry>.py`, found by the name that a traffic mix
gives as its "entry": a class `Entry(Adapter)` that calls one of the
port's entry points and holds the matching call into the plain
reference.

An adapter's `units` are what the comparison judges one by one: the one
mesh of a stream, each mesh of a batch.  It has:

  n_units            how many units a conversion makes
  setup()            set-up the cell's traffic needs (a stream's table)
  convert(keep)      one conversion through the port, ending with a device
                     synchronize; returns a `Conversion`: its work, the
                     kept units' outputs (all where keep is "all", else
                     those whose index is in keep) and, where it folds
                     every output on the device, a digest of them
  unit_arrays(unit)  a kept unit as (int64 keys, uint32 ARGB) numpy arrays
  free()             drops the port's state before the reference runs
  reference(dtype, device)
                     {unit index: (keys, argb, tied)} of the plain
                     reference on the same inputs, in `dtype`

The traced run wraps each conversion in the profiler span
`bench.convert`; an adapter may open spans of its own (`bench.*`) around
its work between its calls into the port.  The port is imported inside the methods, after the cell's
`port_env` is set.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_GOLD = -7046029254386353131  # 0x9E3779B97F4A7C15 as int64
_MIX = -4658895280553007687  # 0xBF58476D1CE4E5B9 as int64


@dataclasses.dataclass
class Conversion:
    """One conversion's record."""

    work: dict  # "triangles", "meshes", "voxels"
    units: dict  # unit index -> (keys int64, argb uint32) arrays or tensors
    digest: object = None  # int64 device scalar of a stream's voxels
    wall_s: float = 0.0
    counters: dict = dataclasses.field(default_factory=dict)


def unit_keys(xyz, resolution):
    """(K, 3) voxel coordinates -> int64 keys x + r (y + r z)."""
    x = xyz.astype(np.int64) if isinstance(xyz, np.ndarray) else xyz.to(torch.int64)
    return (x[:, 2] * resolution + x[:, 1]) * resolution + x[:, 0]


def fold(xyz, argb, resolution):
    """An order-free int64 digest of voxels and their colors, on their
    device."""
    h = unit_keys(xyz, resolution) * _GOLD + (argb.view(torch.int32).to(torch.int64)
                                              & 0xFFFFFFFF)
    h = (h ^ (h >> 31)) * _MIX
    return (h ^ (h >> 29)).sum()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Adapter:
    def __init__(self, config, inputs, device):
        self.config = config
        self.inputs = inputs
        self.device = torch.device(device)
        self.resolution = int(config["resolution"])
        self.strategy = {"max": 0, "blend": 1}[config["strategy"]]
        self.blend = self.strategy == 1

    @staticmethod
    def counters():
        """The port's own counters after a conversion: its wave schedule
        (`engine.WAVE_STATS`) and its host seconds by stage
        (`engine.TIMING_S`, filled under O2V_TIMING=1)."""
        from obj2voxel_tpu_torch import engine
        return {"wave": dict(engine.WAVE_STATS), "timing_s": dict(engine.TIMING_S)}

    @staticmethod
    def reset_counters():
        from obj2voxel_tpu_torch import engine
        engine.TIMING_S.clear()

    def load_kernels(self):
        """Load (or build, on a checkout's first run) the port's kernel
        library."""
        if self.device.type == "cuda":
            from obj2voxel_tpu_torch.ops import _cuda
            _cuda.lib()

    def setup(self):
        pass

    def free(self):
        pass
