"""Debug-mode invariant checks: the TPU analog of the reference's
debug/release assert split (`VXIO_DEBUG_ASSERT*` / `build::DEBUG`, used
throughout the reference and stripped from release builds).

Device code compiled by XLA cannot carry asserts, so the split moves to the
HOST boundary: with ``O2V_DEBUG=1`` the engine re-checks pipeline invariants
on every value that crosses the device->host line (pass counts, merge
counts, yielded voxels).  Checks cost extra host work and device pulls —
exactly like the reference's debug builds cost extra CPU — and compile to
nothing (one module-level bool test) when off.

Invariants checked (all violations raise ``DebugAssertionError``):
  * pass/merge live counts are within [0, buffer size];
  * yielded voxel coordinates lie inside the grid;
  * yielded voxel keys are unique within a slab (outputs per slab are
    disjoint by design — see CLAUDE.md design invariants);
  * yielded z coordinates lie inside the slab's window.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["DEBUG", "DebugAssertionError", "debug_assert", "check_slab_output"]

#: Read once at import, like the reference's compile-time build::DEBUG.
DEBUG = os.environ.get("O2V_DEBUG") == "1"


class DebugAssertionError(AssertionError):
    """An engine invariant failed under O2V_DEBUG=1."""


def debug_assert(cond: bool, msg: str) -> None:
    if not cond:
        raise DebugAssertionError(msg)


def check_count(count: int, limit: int, what: str) -> None:
    debug_assert(0 <= count <= limit, f"{what}: live count {count} outside [0, {limit}]")


def check_slab_output(
    xyz, argb, count: int, *, res_xy: int, z_extent: int, z_lo: int, z_hi: int
) -> None:
    """Validate one yielded slab.

    res_xy / z_extent / z_lo / z_hi are in OUTPUT coordinates (already
    halved when supersampling downscales).  xyz/argb may still be on device
    (count-padded) or host-sliced; only the first `count` rows are checked.
    """
    xyz = np.asarray(xyz)[:count]
    argb = np.asarray(argb)[:count]
    debug_assert(xyz.shape == (count, 3), f"slab xyz shape {xyz.shape} != ({count}, 3)")
    debug_assert(argb.shape == (count,), f"slab argb shape {argb.shape} != ({count},)")
    if count == 0:
        return
    debug_assert(
        bool(
            (xyz >= 0).all()
            and (xyz[:, 0] < res_xy).all()
            and (xyz[:, 1] < res_xy).all()
            and (xyz[:, 2] < z_extent).all()
        ),
        f"slab z[{z_lo},{z_hi}): voxel coordinates outside the grid",
    )
    debug_assert(
        bool((xyz[:, 2] >= z_lo).all() and (xyz[:, 2] < z_hi).all()),
        f"slab z[{z_lo},{z_hi}): z coordinates escape the slab window",
    )
    key = (xyz[:, 2].astype(np.int64) * res_xy + xyz[:, 1]) * res_xy + xyz[:, 0]
    debug_assert(
        np.unique(key).size == count,
        f"slab z[{z_lo},{z_hi}): duplicate voxel keys in final output",
    )
