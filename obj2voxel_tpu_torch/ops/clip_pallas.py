"""K4: standalone clip of (triangle, voxel) pairs (csrc/clip_pairs.cu).

The counterpart of obj2voxel_tpu/ops/clip_pallas.py `clip_pairs_pallas`:
channel-major tri_data (16, P) f32 (rows 0..8 vertex coords, 9..14 UVs
u0 v0 u1 v1 u2 v2, 15 padding) and vox_data (>= 3, P) f32 (rows 0..2 the
voxel's min corner) give (4, P) f32 rows (w, u, v, 0): the clipped area of
each pair and the area-weighted UV centroid of the clipped piece (0, 0 where
w = 0).  Any P; the caller pads nothing.

`clip_pairs` takes the plain version for CPU tensors and launches the CUDA
kernel for CUDA tensors; `clip_pairs_ref` is the plain version,
ops/clip.py's `clip_channels`.
"""

from __future__ import annotations

import torch

from . import _cuda
from .clip import clip_channels


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
    _cuda.LAUNCHES["clip_pairs"] += 1
    return out
