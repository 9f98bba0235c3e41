"""Per-pair color resolution (material color / texture sampling) as torch
ops.

The port of obj2voxel_tpu/ops/color.py `sample_pair_colors_uv`, kept op for
op: materialless triangles are white, untextured ones use their flat color,
textured ones sample their texture at (u, 1 - v) with nearest-pixel lookup
and CLAMP or REPEAT wrap (reference triangle.hpp:181-194).  Every texture
lives in one flat pixel pool (soup.TexturePool).  A one-ulp change of a UV
can move the sample to the next texel, so the order of operations is the
JAX package's exactly: v-flip, scale, floor, wrap, flat index clipped to the
pool.

On the device the pool is int32 (the uint32 ARGB bits reinterpreted): shifts
on uint32 tensors are missing on CUDA, and masking each channel with 0xFF
after the arithmetic shift gives the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import TRI_TEXTURED, UV_CLAMP
from ..soup import TexturePool
from .clip import div_rn


def upload_pool(pool, device):
    """A TexturePool (or None) as device tensors (pixels (B,) int32, meta
    (T, 4) int64 rows (offset, w, h, wrap))."""
    pixels, meta = (pool if pool is not None else TexturePool()).device_arrays()
    return (
        torch.from_numpy(np.ascontiguousarray(pixels).view(np.int32)).to(device),
        torch.from_numpy(meta.astype(np.int64)).to(device),
    )


def sample_pair_colors(uv, tri_type, tri_rgb, tri_tex, pool_pixels, pool_meta):
    """`sample_pair_colors_uv` with the pairs' UVs as one (P, 2) tensor."""
    return sample_pair_colors_uv(uv[:, 0], uv[:, 1], tri_type, tri_rgb, tri_tex,
                                 pool_pixels, pool_meta)


def sample_pair_colors_uv(uv_u, uv_v, tri_type, tri_rgb, tri_tex, pool_pixels,
                          pool_meta):
    """Resolve the colors of a batch of pairs.

    uv_u, uv_v: (P,) float32 UV of each pair; tri_type, tri_tex: (P,) int
    triangle type (TRI_*) and texture id (< 0 when none); tri_rgb: (P, 3)
    float32 flat color; pool_pixels, pool_meta as `upload_pool` gives them.
    Returns (P, 3) float32 rgb in [0, 1]."""
    tex = torch.clamp(tri_tex, 0, pool_meta.shape[0] - 1)
    # one gather a column: on CUDA, gathering whole (T, 4) int64 rows takes
    # ~20x longer than four 1-D gathers
    off, w, h, wrap = (pool_meta[:, j][tex] for j in range(4))

    u = uv_u
    v = 1.0 - uv_v  # v-flip at sample time (reference triangle.hpp:190)
    fx = u * w.to(torch.float32)
    fy = v * h.to(torch.float32)
    ix = torch.floor(fx).to(torch.int64)
    iy = torch.floor(fy).to(torch.int64)

    # REPEAT wraps Python-style (never negative): torch.remainder, not fmod
    clamp = wrap == UV_CLAMP
    zero = torch.zeros_like(ix)
    ix = torch.where(clamp, torch.minimum(torch.maximum(ix, zero), w - 1),
                     torch.remainder(ix, w))
    iy = torch.where(clamp, torch.minimum(torch.maximum(iy, zero), h - 1),
                     torch.remainder(iy, h))

    idx = torch.clamp(off + iy * w + ix, 0, pool_pixels.shape[0] - 1)
    px = pool_pixels[idx]
    r = div_rn(((px >> 16) & 0xFF).to(torch.float32), 255.0)
    g = div_rn(((px >> 8) & 0xFF).to(torch.float32), 255.0)
    b = div_rn((px & 0xFF).to(torch.float32), 255.0)
    tex_rgb = torch.stack([r, g, b], dim=-1)

    use_tex = ((tri_type == TRI_TEXTURED) & (tri_tex >= 0))[:, None]
    return torch.where(use_tex, tex_rgb, tri_rgb)
