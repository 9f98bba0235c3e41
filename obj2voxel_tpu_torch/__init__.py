"""obj2voxel-tpu's voxelizer in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper.

The voxelizer: `Instance` (the reference's C API; native/ builds a C shim
over it), the CLI (`python -m obj2voxel_tpu_torch.cli`), and the engine
beneath them (`voxelize_soup` -> `voxelize_grid` -> `stream_slabs`) for
untextured and textured meshes, with MAX and BLEND color strategies, 2x
supersampling, input-area weights and the merge-runs slab merge; batch mode
(`voxelize_batch`, many small meshes in one stream) and the z-windowed
multi-device path (`parallel.mesh.stream_sharded`).  Everything runs on a
CUDA device unless the caller asks for the CPU: on a CPU device every kernel
wrapper runs its plain PyTorch version, on a CUDA device it launches the
kernel built from `csrc/` (see ops/_cuda.py).  The JAX package
`obj2voxel_tpu` is the reference this package is tested against; nothing
here imports it.
"""

from . import constants
from .api import Instance, Texture, Triangle, get_log_level, set_log_callback, set_log_level
from .constants import (
    BLEND_STRATEGY,
    ERR_DOUBLE_VOXELIZATION,
    ERR_IO_ERROR_DURING_VOXEL_WRITE,
    ERR_IO_ERROR_ON_OPEN_INPUT_FILE,
    ERR_IO_ERROR_ON_OPEN_OUTPUT_FILE,
    ERR_NO_INPUT,
    ERR_NO_OUTPUT,
    ERR_NO_RESOLUTION,
    ERR_OK,
    MAX_STRATEGY,
    UV_CLAMP,
    UV_WRAP,
    VERSION,
)
from .engine import densify, stream_slabs, voxelize_batch, voxelize_grid, voxelize_soup
from .ops._cuda import LAUNCHES, reset_launches
from .soup import TexturePool, TriangleSoup, build_tri_table, table_from_numpy

__version__ = VERSION

__all__ = [
    "Instance", "Texture", "Triangle", "TriangleSoup", "TexturePool",
    "voxelize_soup", "voxelize_batch", "densify", "voxelize_grid",
    "stream_slabs", "build_tri_table",
    "table_from_numpy", "LAUNCHES", "reset_launches",
    "set_log_level", "get_log_level", "set_log_callback", "constants",
    "MAX_STRATEGY", "BLEND_STRATEGY", "UV_CLAMP", "UV_WRAP",
    "ERR_OK", "ERR_NO_INPUT", "ERR_NO_OUTPUT", "ERR_NO_RESOLUTION",
    "ERR_IO_ERROR_ON_OPEN_INPUT_FILE", "ERR_IO_ERROR_ON_OPEN_OUTPUT_FILE",
    "ERR_IO_ERROR_DURING_VOXEL_WRITE", "ERR_DOUBLE_VOXELIZATION", "VERSION",
]
