"""The plain reference voxelizer: every (triangle, voxel) pair of each
triangle's voxel AABB, clipped in plain PyTorch, combined per voxel.

The semantics are obj2voxel's (reference src/voxelization.cpp,
src/triangle.hpp): a triangle occupies a voxel where the part of it that
the voxel's cube clips off has a non-zero area (a Sutherland-Hodgman clip
against the six faces with the reference's epsilon rule that planar
points go to the upper side), and that area is the pair's weight.  BLEND
gives a voxel the weight-averaged color of its triangles, MAX the color of
its heaviest triangle; a tie of different colors is marked, since the
program breaks it by its own pass order.  A color is
packed as ARGB with alpha 255 and each channel round(255 c).

The clip's float32 operations are the program's plain version's, in its
order, written out again here (each product and sum its own rounded
operation, square roots rounded once from float64), so that occupancy
compares exactly.  The combine sums in float64.  `dtype` computes the
triangles' coordinates and the whole clip in another precision: the
control that has to come out as not correct runs it in bfloat16.

It works on any device, in chunks of pairs, and imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np
import torch

#: A point this close to a clip plane counts as on it (reference EPSILON).
EPSILON = 1.0 / (1 << 16)


def _clip_plane(slots, count, axis, plane, keep_hi):
    """One Sutherland-Hodgman pass over closed polygons held as a list of
    C (3, P) vertex slots (slot[count] repeats slot[0]).  Returns C + 1
    slots and the new counts."""
    n_slots = len(slots)
    vals = [s[axis] for s in slots]
    valid = [count > i for i in range(n_slots)]
    all_lo = None
    for i in range(n_slots - 1):
        lo_i = (vals[i] < plane) | ~valid[i]
        all_lo = lo_i if all_lo is None else (all_lo & lo_i)
    inside = []
    for i in range(n_slots):
        if keep_hi:
            inside.append(((plane - vals[i]) < EPSILON) & ~all_lo)
        else:
            inside.append(all_lo | ((vals[i] < plane) & ((plane - vals[i]) >= EPSILON)))

    prefix = torch.zeros_like(count)
    emit_cur, emit_x, dest_cur, dest_x, isect = [], [], [], [], []
    for i in range(n_slots - 1):
        e_cur = inside[i] & valid[i]
        e_x = (inside[i] != inside[i + 1]) & valid[i]
        emit_cur.append(e_cur)
        emit_x.append(e_x)
        dest_cur.append(prefix)
        prefix = prefix + e_cur.to(count.dtype)
        dest_x.append(prefix)
        prefix = prefix + e_x.to(count.dtype)
        d = vals[i] - vals[i + 1]
        t = torch.where(d.abs() < EPSILON, torch.zeros_like(d),
                        (vals[i] - plane) / torch.where(d == 0, torch.ones_like(d), d))
        isect.append((1.0 - t) * slots[i] + t * slots[i + 1])

    zero = torch.zeros_like(slots[0])
    out = []
    for s in range(n_slots + 1):
        acc = zero
        for i in range(n_slots - 1):
            if s > 2 * i + 1:
                continue
            acc = acc + torch.where(emit_cur[i] & (dest_cur[i] == s), slots[i], zero)
            acc = acc + torch.where(emit_x[i] & (dest_x[i] == s), isect[i], zero)
        out.append(acc)
    closed = [out[0]] + [out[s] + torch.where(prefix == s, out[0], zero)
                         for s in range(1, n_slots + 1)]
    return closed, prefix


def _sqrt_rn(x):
    """Square root rounded once to x's precision (a float64 root rounded
    to float32 is the correctly rounded float32 root)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def clipped_area(tri, vox):
    """tri (9, P) vertex coordinates, vox (3, P) voxel minimum corners, in
    one float dtype: the area of each triangle inside its voxel's cube."""
    s0 = tri[0:3]
    slots = [s0, tri[3:6], tri[6:9], s0]
    count = torch.full((tri.shape[1],), 3, dtype=torch.int32, device=tri.device)
    for hi in (False, True):
        for axis in range(3):
            plane = vox[axis] + (1.0 if hi else 0.0)
            slots, count = _clip_plane(slots, count, axis, plane, keep_hi=not hi)
    x0, y0, z0 = slots[0]
    weight = torch.zeros_like(x0)
    for i in range(1, len(slots) - 1):
        a, b = slots[i], slots[i + 1]
        ax, ay, az = a[0] - x0, a[1] - y0, a[2] - z0
        bx, by, bz = b[0] - x0, b[1] - y0, b[2] - z0
        cx = ay * bz - az * by
        cy = az * bx - ax * bz
        cz = ax * by - ay * bx
        area = 0.5 * _sqrt_rn(cx * cx + cy * cy + cz * cz)
        weight = weight + torch.where(count > i + 1, area, torch.zeros_like(area))
    return weight


def _aabbs(verts, stride, z_extent):
    """Each triangle's voxel AABB, [floor(min), floor(max) + 1) clamped to
    the grid, as int64 (N, 3) lo and hi."""
    hi_clamp = torch.tensor([stride, stride, z_extent], device=verts.device)
    lo = torch.floor(verts.amin(dim=1)).to(torch.int64)
    hi = torch.floor(verts.amax(dim=1)).to(torch.int64) + 1
    lo = torch.minimum(torch.clamp(lo, min=0), hi_clamp)
    hi = torch.minimum(torch.clamp(hi, min=0), hi_clamp)
    return lo, hi


def _pairs(verts, rgb, lo, size, t0, t1, first, stride):
    """The live pairs of triangles [t0, t1): global int64 keys, the float
    channels (w, w r, w g, w b) and the triangle of each, in triangle
    order, then voxel rank order."""
    dev = verts.device
    n = size[t0:t1].prod(dim=1)
    tri = torch.repeat_interleave(torch.arange(t0, t1, device=dev), n)
    if tri.numel() == 0:
        return None
    rank = torch.arange(tri.numel(), device=dev) - (first[tri] - first[t0])
    sx, sy = size[tri, 0], size[tri, 1]
    rest = rank // sx
    vx = lo[tri, 0] + rank % sx
    vy = lo[tri, 1] + rest % sy
    vz = lo[tri, 2] + rest // sy
    vox = torch.stack([vx, vy, vz]).to(verts.dtype)
    w = clipped_area(verts[tri].reshape(-1, 9).T, vox)
    live = w > 0
    tri, w = tri[live], w[live]
    key = (vz[live] * stride + vy[live]) * stride + vx[live]
    c = rgb[tri].to(w.dtype)
    return key, torch.stack([w, w * c[:, 0], w * c[:, 1], w * c[:, 2]]), tri


def pack_argb(rgb):
    """(3, V) float channels in [0, 1] -> (V,) ARGB words, alpha 255,
    each channel rounded to nearest, ties to even."""
    q = torch.clamp(torch.round(rgb * 255.0), 0, 255).to(torch.int64)
    return 0xFF000000 | (q[0] << 16) | (q[1] << 8) | q[2]


def voxelize(verts, rgb, *, stride, z_extent, blend, device="cpu",
             dtype=torch.float32, chunk_pairs=1 << 22):
    """Voxelize (N, 3, 3) triangles already in voxel space on a grid of
    [0, stride) in x and y and [0, z_extent) in z; rgb (N, 3) colors in
    [0, 1].  Returns the occupied voxels' keys x + stride (y + stride z)
    (int64, ascending), their ARGB words (uint32) and whether each is
    tied: under MAX, its heaviest weight shared by triangles of different
    colors, so that its color is the program's first of them in an order
    the reference does not follow; as numpy arrays."""
    dev = torch.device(device)
    verts = torch.as_tensor(verts).to(dev).to(dtype)
    rgb = torch.as_tensor(rgb).to(dev).to(torch.float32)
    lo, hi = _aabbs(verts, stride, z_extent)
    size = torch.clamp(hi - lo, min=0)
    per_tri = size.prod(dim=1)
    first = torch.cumsum(per_tri, 0) - per_tri
    ends = torch.cumsum(per_tri, 0).cpu()
    keys, chans, tris = [], [], []
    t0, n_tri = 0, verts.shape[0]
    while t0 < n_tri:
        # the most triangles from t0 whose pairs fit in one chunk (one at least)
        limit = int(ends[t0 - 1]) + chunk_pairs if t0 else chunk_pairs
        t1 = max(t0 + 1, int(torch.searchsorted(ends, limit, right=True)))
        got = _pairs(verts, rgb, lo, size, t0, min(t1, n_tri), first, stride)
        if got is not None:
            keys.append(got[0])
            chans.append(got[1])
            tris.append(got[2])
        t0 = t1
    if not keys:
        return np.zeros(0, np.int64), np.zeros(0, np.uint32), np.zeros(0, bool)
    key, order = torch.sort(torch.cat(keys), stable=True)
    chan = torch.cat(chans, dim=1)[:, order]
    tri = torch.cat(tris)[order]
    del keys, chans, tris
    uniq, seg = torch.unique_consecutive(key, return_inverse=True)
    n_vox = uniq.shape[0]
    tied = torch.zeros(n_vox, dtype=torch.bool, device=dev)
    if blend:
        sums = torch.zeros((4, n_vox), dtype=torch.float64, device=dev)
        sums.index_add_(1, seg, chan.to(torch.float64))
        argb = pack_argb(sums[1:] / sums[0])
    else:
        w = chan[0].to(torch.float32)
        best = torch.full((n_vox,), -1.0, device=dev).scatter_reduce(
            0, seg, w, "amax", include_self=True)
        top = w == best[seg]
        pos = torch.arange(w.shape[0], device=dev)
        pos = torch.where(top, pos, torch.full_like(pos, w.shape[0]))
        win = torch.full((n_vox,), w.shape[0], device=dev).scatter_reduce(
            0, seg, pos, "amin", include_self=True)
        c = chan[:, win].to(torch.float32)
        # the winner's premultiplied color divided back in float32, with
        # the one residual correction of an exact divide
        q = c[1:] / c[0]
        argb = pack_argb(q + (c[1:] - q * c[0]) / c[0])
        # a voxel whose heaviest weight several triangles of different
        # colors share: its color depends on which the program meets first
        for ch in range(3):
            x = rgb[tri, ch]
            lo = torch.full((n_vox,), 2.0, device=dev).scatter_reduce(
                0, seg[top], x[top], "amin", include_self=True)
            hi = torch.full((n_vox,), -1.0, device=dev).scatter_reduce(
                0, seg[top], x[top], "amax", include_self=True)
            tied |= lo != hi
    return uniq.cpu().numpy(), argb.cpu().numpy().astype(np.uint32), tied.cpu().numpy()
