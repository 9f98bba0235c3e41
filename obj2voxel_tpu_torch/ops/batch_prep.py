"""A batch's host prep on the device: every mesh's bounds, transform,
subdivision and z offset at once, and the stacked (N_pad, 24) table.

`batch_table` gives, bit for bit, what `engine.voxelize_batch` would get
from one `engine.prepare_soup` a mesh (`geometry.compute_mesh_transform`,
`AffineTransform.apply`, `ops/subdivide.subdivide_soup`), the float32 z
stack and `engine.host_table`, with the soups' columns uploaded once:

  bounds      one segmented min and max over each mesh's vertices (exact);
  transform   the compose chain of `compute_mesh_transform` with the
              identity unit transform, every matrix diagonal: each entry of
              a numpy float32 product of diagonal matrices is one rounded
              product (the other terms are exact zeros), so a mesh's chain is
              m = h k, t = h ((k (-min) - 1) + 1) + ANTI_BLEED / 2 with k =
              2 / max_axis and h = (r - ANTI_BLEED) / 2, and `apply` is one
              multiply and one add a coordinate, each rounded once;
  subdivide   `subdivide_soup`'s rounds over every mesh's triangles
              together.  A round keeps each mesh's triangles in their order,
              so the round-major output is the per-mesh loop's up to the
              mesh: one stable sort by mesh gives mesh-major, then round,
              then place;
  z stack     mesh i's z + i r_s in float32, after the sort;
  table       `build_tri_table`'s layout, zero-padded to a power of two,
              and `host_table`'s clamped voxel AABBs, pulled to the host
              once for `stream_slabs`'s `aabb_host`.

Only single elementwise torch ops (mul, add, sub, div, abs, floor, min and
max, compares, gathers) compute the geometry: no `cross`, `norm`, `sum` over
the 3-axis, `addcmul` or `lerp`, whose CUDA kernels may contract a
multiply-add into an FMA or reorder a sum.  numpy sums a row of three as
(s0 + s1) + s2, and so does this module; square roots are taken in float64
and rounded once (`clip._sqrt_rn`), divisions by a constant divide by a
device tensor (`clip.div_rn`).  The numpy path stays the plain reference
and the path of `voxelize_soup` and `parallel/mesh.py`; UVs are taken as
float32, as `TriangleSoup` holds them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    ANTI_BLEED, COS_SUBDIVISION_DIAGONALITY_LIMIT, SUBDIVISION_VOLUME_LIMIT,
)
from ..io import debug_stl
from ..soup import pow2_at_least
from .clip import _sqrt_rn, div_rn
from .subdivide import _SQRT_THIRD

__all__ = ["batch_table"]

#: float32 constants of `roughly_axis_aligned`, as numpy rounds them there
_SQRT_THIRD_F32 = float(np.float32(_SQRT_THIRD))
_DIAG_SPAN_F32 = float(np.float32(1.0 - _SQRT_THIRD))

#: `subdivide_soup`'s default max_rounds, the one `prepare_soup` takes
MAX_ROUNDS = 24


def _upload(columns, device):
    """The host columns (verts, uvs, types, rgb, tex) as device tensors."""
    dtypes = (np.float32, np.float32, None, np.float32, None)
    return [torch.from_numpy(np.ascontiguousarray(c, dtype=d)).to(device)
            for c, d in zip(columns, dtypes)]


def _transform(verts, mesh, n_meshes, sample_res):
    """Each mesh normalized to [0, sample_res)^3 as `prepare_soup` does
    with no bounds and no unit transform; `mesh` is each row's mesh."""
    idx = mesh[:, None].expand(-1, 3)
    inf = torch.full((n_meshes, 3), float("inf"), device=verts.device)
    lo = inf.scatter_reduce(0, idx, verts.amin(1), "amin", include_self=False)
    hi = (-inf).scatter_reduce(0, idx, verts.amax(1), "amax", include_self=False)
    k = torch.full((n_meshes,), 2.0, device=verts.device) / (hi - lo).amax(1)
    h = float(np.float32(np.float32(sample_res) - np.float32(ANTI_BLEED))
              / np.float32(2.0))
    t = (k[:, None] * -lo) + -1.0
    t = t + 1.0
    t = (t * h) + ANTI_BLEED / 2.0
    m = k * h
    return (verts * m[mesh][:, None, None]) + t[mesh][:, None, :]


def _roughly_axis_aligned(v):
    """`subdivide.roughly_axis_aligned`, one rounding an op in its order."""
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = [e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
         e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
         e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]]
    norm = _sqrt_rn((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2])
    norm = torch.where(norm > 0, norm, torch.ones_like(norm))
    a = [torch.abs(x) / norm for x in n]
    diagonality = ((a[0] + a[1]) + a[2]) * _SQRT_THIRD_F32
    diagonality01 = div_rn(diagonality - _SQRT_THIRD_F32, _DIAG_SPAN_F32)
    return diagonality01 < COS_SUBDIVISION_DIAGONALITY_LIMIT


def _aabb_volume(v):
    """`subdivide._aabb_volume` in float32."""
    size = torch.clamp_min(
        (torch.floor(v.amax(1)) + 1.0) - torch.floor(v.amin(1)), 0.0)
    return (size[:, 0] * size[:, 1]) * size[:, 2]


def _split4(s):
    """The four Sierpinski pieces of (S, 3, C) triangles, piece-major:
    centres, then the pieces at corners 0, 1, 2 (`subdivide_soup`)."""
    a, b, c = s[:, 0], s[:, 1], s[:, 2]
    g0, g1, g2 = (a + b) * 0.5, (b + c) * 0.5, (c + a) * 0.5
    return torch.cat([torch.stack(p, 1) for p in
                      ((g0, g1, g2), (a, g0, g2), (b, g1, g0), (c, g2, g1))])


def _subdivide(verts, uvs):
    """`subdivide_soup`'s rounds over all rows at once: (verts, uvs, source
    row) in round-major order, and the number of checks made."""
    work = (verts, uvs, torch.arange(verts.shape[0], device=verts.device))
    aligned = _roughly_axis_aligned(verts)
    done, checks = [], 0
    for _ in range(MAX_ROUNDS):
        if work[0].shape[0] == 0:
            break
        split = _aabb_volume(work[0]) >= SUBDIVISION_VOLUME_LIMIT
        if aligned is not None:
            split &= ~aligned
        checks += 1
        cut = torch.nonzero(split).squeeze(1)
        if cut.shape[0] == 0:
            break
        keep = torch.nonzero(~split).squeeze(1)
        done.append(tuple(x.index_select(0, keep) for x in work))
        v, u, src = (x.index_select(0, cut) for x in work)
        work, aligned = (_split4(v), _split4(u), src.repeat(4)), None
    done.append(work)
    return [torch.cat(col) for col in zip(*done)], checks


def batch_table(soups, sample_res, device):
    """The stacked table of `soups` on `device`, mesh i normalized to its
    own [0, sample_res)^3 grid and moved to z in [i r_s, (i + 1) r_s).

    Returns (table (N_pad, 24) float32 on device, (vmin, vmax) host int32
    (N, 3) voxel AABBs, stats {meshes, triangles_in, triangles_out, rounds}),
    or None when every soup is empty.  The AABBs are clamped to the grid
    [0, sample_res)^2 x [0, len(soups) r_s), vmax exclusive."""
    sizes = np.array([len(s) for s in soups], np.int64)
    slot = np.flatnonzero(sizes)
    if slot.size == 0:
        return None
    verts, uvs, types, rgb, tex = _upload(
        (np.concatenate(c) for c in zip(*((s.verts, s.uvs, s.types, s.rgb, s.tex)
                                         for s in soups if len(s)))), device)
    n_in = verts.shape[0]
    mesh = torch.repeat_interleave(
        torch.arange(slot.size, device=device),
        torch.from_numpy(sizes[slot]).to(device), output_size=n_in)
    verts = _transform(verts, mesh, slot.size, sample_res)
    (verts, uvs, src), checks = _subdivide(verts, uvs)
    # mesh-major, then round, then place: the per-mesh loop's order
    owner, order = torch.sort(mesh.index_select(0, src), stable=True)
    src = src.index_select(0, order)
    verts = verts.index_select(0, order)
    uvs = uvs.index_select(0, order)
    if debug_stl.enabled():
        debug_stl.record(verts.cpu().numpy())  # as prepare_soup records them
    z_off = torch.from_numpy(slot.astype(np.float32) * np.float32(sample_res))
    verts[:, :, 2] += z_off.to(device).index_select(0, owner)[:, None]

    n = verts.shape[0]
    table = torch.zeros((pow2_at_least(n), 24), dtype=torch.float32, device=device)
    table[:n, 0:9] = verts.reshape(n, 9)
    table[:n, 9:15] = uvs.reshape(n, 6)
    table[:n, 16] = types.index_select(0, src).to(torch.float32)
    table[:n, 17:20] = rgb.index_select(0, src)
    table[:n, 20] = tex.index_select(0, src).to(torch.float32)
    hi = torch.tensor([sample_res, sample_res, len(soups) * sample_res],
                      dtype=torch.float32, device=device)
    aabb = torch.stack([torch.floor(verts.amin(1)), torch.floor(verts.amax(1)) + 1.0])
    aabb = torch.minimum(torch.clamp_min(aabb, 0.0), hi).to(torch.int32).cpu().numpy()
    stats = {"meshes": int(slot.size), "triangles_in": n_in, "triangles_out": n,
             "rounds": checks}
    return table, (aabb[0], aabb[1]), stats
