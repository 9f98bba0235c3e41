"""Tuning constants and public enums.

Mirrors the reference's compile-time constants (reference: src/constants.hpp:10-27)
and the public enums of the C API (reference: include/obj2voxel.h:43-79), but the
values here tune a TPU pipeline (tile sizes) rather than a CPU worker pool.
"""

# --- Geometry / algorithm constants (reference: src/voxelization.cpp:15, constants.hpp:13-15)

#: Epsilon used for "is on plane" tests during clipping (reference EPSILON = 2^-16).
EPSILON = 1.0 / (1 << 16)

#: Triangles whose voxel-AABB volume exceeds this limit are subdivided
#: (reference SUBDIVISION_VOLUME_LIMIT, constants.hpp:13).
SUBDIVISION_VOLUME_LIMIT = 512

#: Normalized diagonality threshold below which a triangle counts as roughly
#: axis-aligned and is not subdivided (reference COS_SUBDIVISION_DIAGONALITY_LIMIT).
COS_SUBDIVISION_DIAGONALITY_LIMIT = 0.5

#: Plane-distance pre-filter limit: voxels whose center is further than this from
#: the triangle plane cannot intersect it (reference voxelization.cpp:435).
PLANE_DISTANCE_LIMIT = 2.0

#: Shrink applied by the mesh transform so geometry never lands exactly on the
#: outer grid boundary (reference obj2voxel.cpp:372).
ANTI_BLEED = 0.5

# --- Engine tuning (TPU-specific; the reference's CHUNK_SIZE=64 / BATCH_SIZE=1024
#     command-queue constants map to tile/slab sizes here).

#: Chunk size reported through the public API for compatibility
#: (reference CHUNK_SIZE, constants.hpp:10).
CHUNK_SIZE = 64

#: Cap on pair slots per fused device pass (the effective pass budget is
#: min(PAIR_TILE, engine.MAX_PASS_BUDGET)).  Tests pass a small value to keep
#: XLA CPU compiles fast; production uses the full budget.
PAIR_TILE = 1 << 21

#: Triangle counts are padded up to multiples of this to bound jit recompiles.
TRIANGLE_PAD = 1 << 12

#: Maximum resolution handled with a single int32 voxel key (x + r*y + r^2*z < 2^31).
MAX_SINGLE_PASS_RESOLUTION = 1024

#: Maximum vertex count of a triangle clipped by 6 planes (3 + 6).
CLIP_VCAP = 9

# --- Public enums (reference: include/obj2voxel.h:43-79)

MAX_STRATEGY = 0
BLEND_STRATEGY = 1

UV_CLAMP = 0
UV_WRAP = 1

LOG_LEVEL_SILENT = 0
LOG_LEVEL_ERROR = 1
LOG_LEVEL_WARNING = 2
LOG_LEVEL_INFO = 3
LOG_LEVEL_DEBUG = 4
#: voxelio-internal level below DEBUG (not part of the public C enum);
#: per-slab progress logs use it (reference src/obj2voxel.cpp:304-308).
LOG_LEVEL_SPAM = 5

ERR_OK = 0
ERR_NO_INPUT = 1
ERR_NO_OUTPUT = 2
ERR_NO_RESOLUTION = 3
ERR_IO_ERROR_ON_OPEN_INPUT_FILE = 4
ERR_IO_ERROR_ON_OPEN_OUTPUT_FILE = 5
ERR_IO_ERROR_DURING_VOXEL_WRITE = 6
ERR_DOUBLE_VOXELIZATION = 7

# Triangle material types (reference: src/triangle.hpp:21-29)
TRI_NONE = 0
TRI_MATERIALLESS = 1
TRI_UNTEXTURED = 2
TRI_TEXTURED = 3

VERSION = "0.1.0"
