"""K4: standalone clip of (triangle, voxel) pairs (csrc/clip_pairs.cu).

The counterpart of obj2voxel_tpu/ops/clip_pallas.py `clip_pairs_pallas`:
channel-major tri_data (16, P) f32 (rows 0..8 vertex coords, 9..14 UVs
u0 v0 u1 v1 u2 v2, 15 padding) and vox_data (>= 3, P) f32 (rows 0..2 the
voxel's min corner) give (4, P) f32 rows (w, u, v, 0): the clipped area of
each pair and the area-weighted UV centroid of the clipped piece (0, 0 where
w = 0).  Any P; the caller pads nothing.

`clip_pairs` takes the plain version for CPU tensors and launches the CUDA
kernel for CUDA tensors; `clip_pairs_ref` is the plain version,
ops/clip.py's `clip_channels`.  `clip_triangles_to_voxels_pallas` is the
per-pair public entry point over it (obj2voxel_tpu/ops/clip_pallas.py:92),
the twin of ops/clip.clip_triangles_to_voxels.
"""

from __future__ import annotations

import torch

from . import _cuda
from .clip import clip_channels
from .pass_fused import slot_voxels


def clip_pairs_ref(tri_data, vox_data):
    """Plain version: (4, P) f32 rows (w, u, v, 0)."""
    w, u, v = clip_channels(tri_data, vox_data)
    return torch.cat([w, u, v, torch.zeros_like(w)])


def _check(tri_data, vox_data):
    if tri_data.dtype != torch.float32 or tri_data.dim() != 2 or tri_data.shape[0] != 16:
        raise ValueError("clip_pairs: tri_data must be a (16, P) float32 tensor")
    if (vox_data.dtype != torch.float32 or vox_data.dim() != 2
            or vox_data.shape[0] < 3 or vox_data.shape[1] != tri_data.shape[1]):
        raise ValueError("clip_pairs: vox_data must be a (>=3, P) float32 tensor")
    if tri_data.shape[1] >= 1 << 31:
        raise ValueError("clip_pairs: more pairs than int32 indexing")


def clip_pairs(tri_data, vox_data):
    """Clip every pair: (4, P) f32 rows (w, u, v, 0)."""
    _check(tri_data, vox_data)
    if tri_data.device.type == "cpu":
        return clip_pairs_ref(tri_data, vox_data)
    dev = _cuda.require_cuda("clip_pairs", tri_data, vox_data)
    # the kernel reads rows at a stride of P floats
    tri_data, vox_data = tri_data.contiguous(), vox_data.contiguous()
    n = tri_data.shape[1]
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    err = _cuda.lib().o2v_clip_pairs(
        tri_data.data_ptr(), vox_data.data_ptr(), out.data_ptr(), n,
        _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "clip_pairs")
    _cuda.count_launch("clip_pairs")
    return out


def clip_triangles_to_voxels_pallas(verts, uvs, voxel_pos):
    """ops/clip.clip_triangles_to_voxels through `clip_pairs` (K4 on a CUDA
    device): verts (P, 3, 3), uvs (P, 3, 2), voxel_pos (P, 3) tensors on one
    device -> (weight (P,), uv (P, 2)) float32."""
    n = verts.shape[0]
    f32 = torch.float32
    tri = torch.cat([verts.reshape(n, 9).T.to(f32), uvs.reshape(n, 6).T.to(f32),
                     torch.zeros((1, n), dtype=f32, device=verts.device)])
    vox = torch.cat([voxel_pos.T.to(f32),
                     torch.zeros((1, n), dtype=f32, device=verts.device)])
    out = clip_pairs(tri, vox)
    return out[0], out[1:3].T


def pass_pairs(table_t, r0, n_rows, local_base, z_lo, z_hi, stride, *, expand,
               budget, wide_local):
    """The (triangle, voxel) pairs of one pass, laid out for `clip_pairs`
    (the engine's passes decode their slots in K1 instead).

    `table_t` is the plan-ordered table channel-major, (24, M).  Slot s of
    the budget belongs to row r0 + (s >> log2(expand)) and has within-AABB
    rank local_base + (s & (expand - 1)); the rank decodes to a voxel as in
    obj2voxel_tpu/engine.py:410-480.  Returns (tri_data (16, budget) f32,
    vox_data (4, budget) f32, attrs (5, budget) f32 = the slot rows' columns
    16:21 (type, r, g, b, texture id), voxel (vx, vy, vz) int64, valid
    (budget,) bool: the slot's row is one of the pass's and its rank lies in
    the row's AABB)."""
    dev = table_t.device
    slot = torch.arange(budget, dtype=torch.int64, device=dev)
    row = slot >> (expand.bit_length() - 1)
    row_live = row < n_rows
    row = torch.clamp(row, max=n_rows - 1)
    local = local_base + (slot & (expand - 1))
    vx, vy, vz, inside = slot_voxels(table_t[:, r0 : r0 + n_rows].T, row, local,
                                     z_lo, z_hi, stride, wide_local)
    # one gather of the 21 used columns; both slices stay contiguous
    cols = table_t[0:21, r0 + row]
    vox = torch.stack([vx, vy, vz, torch.zeros_like(vx)]).to(torch.float32)
    return cols[0:16], vox, cols[16:21], (vx, vy, vz), row_live & inside
