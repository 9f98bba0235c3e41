"""obj2voxel-tpu's voxelizer in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper.

The main path for untextured meshes on one device: `voxelize_soup` ->
`voxelize_grid` -> `stream_slabs`, with MAX and BLEND color strategies.  The
device is an argument: on a CPU device every kernel wrapper runs its plain
PyTorch version, on a CUDA device it launches the kernel built from
`csrc/` (see ops/_cuda.py).  The JAX package `obj2voxel_tpu` is the
reference this package is tested against; nothing here imports it.
"""

from .constants import BLEND_STRATEGY, MAX_STRATEGY, VERSION
from .engine import stream_slabs, voxelize_grid, voxelize_soup
from .ops._cuda import LAUNCHES, reset_launches
from .soup import TexturePool, TriangleSoup, build_tri_table, table_from_numpy

__version__ = VERSION

__all__ = [
    "BLEND_STRATEGY", "LAUNCHES", "MAX_STRATEGY", "TexturePool",
    "TriangleSoup", "build_tri_table", "reset_launches", "stream_slabs",
    "table_from_numpy", "voxelize_grid", "voxelize_soup",
]
