"""Triangle/voxel-cube clipping as torch ops.

The port of obj2voxel_tpu/ops/clip.py:57-195, kept op for op: a branch-free,
fixed-capacity Sutherland-Hodgman pass over the voxel's six planes on closed
polygons (slot[count] duplicates slot[0]), with the reference's epsilon
"planar goes hi" rules and the clipped area as weight.  See the JAX module's
docstring for the semantics.  This is the plain version inside the fused
pass kernel's plain version (ops/pass_fused.py); csrc/fused_pass.cu runs the
same operations in the same order per slot.  `clip_triangles_to_voxels` is
the public per-pair entry point (K4's layout wrapper is
ops/clip_pallas.clip_triangles_to_voxels_pallas).
"""

from __future__ import annotations

import torch

from ..constants import EPSILON


def _clip_one_plane(slots, count, axis, plane, keep_hi):
    """One Sutherland-Hodgman pass over a batch of closed polygons.

    slots: list of C tensors, each (5, P) float32; closed representation.
    count: (P,) int32 number of distinct vertices.
    plane: (P,) float32; axis: python int; keep_hi: python bool.

    Returns (slots', count') with len(slots') == len(slots) + 1.
    """
    C = len(slots)
    vals = [s[axis] for s in slots]
    valid = [count > i for i in range(C)]

    all_lo = None
    for i in range(C - 1):
        lo_i = (vals[i] < plane) | ~valid[i]
        all_lo = lo_i if all_lo is None else (all_lo & lo_i)

    inside = []
    for i in range(C):
        if keep_hi:
            ins = ((plane - vals[i]) < EPSILON) & ~all_lo
        else:
            ins = all_lo | ((vals[i] < plane) & ((plane - vals[i]) >= EPSILON))
        inside.append(ins)

    prefix = torch.zeros_like(count)
    emit_cur, emit_x, dest_cur, dest_x, isect = [], [], [], [], []
    for i in range(C - 1):
        edge_valid = valid[i]
        e_cur = inside[i] & edge_valid
        e_x = (inside[i] != inside[i + 1]) & edge_valid
        emit_cur.append(e_cur)
        emit_x.append(e_x)
        dest_cur.append(prefix)
        prefix = prefix + e_cur.to(count.dtype)
        dest_x.append(prefix)
        prefix = prefix + e_x.to(count.dtype)

        d = vals[i] - vals[i + 1]
        t = torch.where(
            d.abs() < EPSILON,
            torch.zeros_like(d),
            (vals[i] - plane) / torch.where(d == 0, torch.ones_like(d), d),
        )
        isect.append((1.0 - t) * slots[i] + t * slots[i + 1])

    new_count = prefix

    C_out = C + 1
    zero = torch.zeros_like(slots[0])
    out = []
    for s in range(C_out):
        acc = zero
        for i in range(C - 1):
            if s > 2 * i + 1:
                continue
            m_cur = emit_cur[i] & (dest_cur[i] == s)
            acc = acc + torch.where(m_cur, slots[i], zero)
            m_x = emit_x[i] & (dest_x[i] == s)
            acc = acc + torch.where(m_x, isect[i], zero)
        out.append(acc)

    closed = [out[0]]
    for s in range(1, C_out):
        closed.append(out[s] + torch.where(new_count == s, out[0], zero))
    return closed, new_count


def _clip_polygons(slots, count, voxel_f):
    """All six plane clips in the reference's order: keep-hi at pos[axis],
    then keep-lo at pos[axis]+1, axes x, y, z each."""
    for hi in (False, True):
        for axis in range(3):
            plane = voxel_f[axis] + (1.0 if hi else 0.0)
            slots, count = _clip_one_plane(slots, count, axis, plane, keep_hi=not hi)
    return slots, count


def _sqrt_rn(x):
    """float32 square root rounded to nearest, like the kernels'
    `__fsqrt_rn`: PyTorch's vectorized CPU sqrt is off by one ulp on ~0.7%
    of float32 inputs, and a float64 root rounded once to float32 is exact."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _area_uv(slots, count):
    """Area + area-weighted UV centroid via a triangle fan from slot 0."""
    C = len(slots)
    x0, y0, z0, u0, v0 = slots[0]
    zero = torch.zeros_like(x0)
    weight = zero
    uv_num_u = zero
    uv_num_v = zero
    for i in range(1, C - 1):
        a = slots[i]
        b = slots[i + 1]
        ax, ay, az = a[0] - x0, a[1] - y0, a[2] - z0
        bx, by, bz = b[0] - x0, b[1] - y0, b[2] - z0
        cx = ay * bz - az * by
        cy = az * bx - ax * bz
        cz = ax * by - ay * bx
        piece_valid = count > i + 1
        area = 0.5 * _sqrt_rn(cx * cx + cy * cy + cz * cz)
        area = torch.where(piece_valid, area, zero)
        weight = weight + area
        uv_num_u = uv_num_u + area * div_rn(u0 + a[3] + b[3], 3.0)
        uv_num_v = uv_num_v + area * div_rn(v0 + a[4] + b[4], 3.0)

    safe_w = torch.where(weight > 0, weight, torch.ones_like(weight))
    return weight, uv_num_u / safe_w, uv_num_v / safe_w


def div_rn(x, c):
    """x / c rounded to nearest for a Python number c: on CUDA, PyTorch
    divides by a CPU scalar as a multiplication by its reciprocal, which
    is one ulp off for some x; a divisor tensor on x's device is divided
    exactly, like the kernels' `__fdiv_rn`."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def clip_channels(tri_data, vox_data):
    """Channel-major clip: tri_data (16, P) f32 (rows 0..8 vertex coords,
    rows 9..14 UVs, row 15 pad), vox_data (>=3, P) f32 voxel min corner.
    Returns (weight (1, P), uv_u (1, P), uv_v (1, P))."""
    t = tri_data

    def slot(i):
        return torch.cat([t[3 * i : 3 * i + 3], t[9 + 2 * i : 9 + 2 * i + 2]], dim=0)

    s0 = slot(0)
    slots = [s0, slot(1), slot(2), s0]
    count = torch.full((1, t.shape[1]), 3, dtype=torch.int32, device=t.device)
    voxel_f = [vox_data[0:1], vox_data[1:2], vox_data[2:3]]
    slots, count = _clip_polygons(slots, count, voxel_f)
    return _area_uv(slots, count)


def clip_triangles_to_voxels(verts, uvs, voxel_pos):
    """Clip each triangle against its voxel's cube; return (weight, uv).

    verts (P, 3, 3) triangle vertices in voxel-grid space, uvs (P, 3, 2)
    per-vertex texture coordinates, voxel_pos (P, 3) the voxel's minimum
    corner (tensors or arrays; computed in float32 on verts' device).
    Returns weight (P,) float32, the clipped polygon's area (0 where the
    triangle does not occupy the voxel under the reference's epsilon
    rules), and uv (P, 2) float32, the area-weighted UV centroid of the
    clipped region."""
    verts = torch.as_tensor(verts).to(torch.float32)
    dev = verts.device
    uvs = torch.as_tensor(uvs, device=dev).to(torch.float32)
    voxel_pos = torch.as_tensor(voxel_pos, device=dev)
    voxel_f = [voxel_pos[:, a].to(torch.float32) for a in range(3)]

    def slot(i):
        return torch.stack([verts[:, i, 0], verts[:, i, 1], verts[:, i, 2],
                            uvs[:, i, 0], uvs[:, i, 1]])

    s0 = slot(0)
    slots = [s0, slot(1), slot(2), s0]  # closed triangle
    count = torch.full((verts.shape[0],), 3, dtype=torch.int32, device=dev)
    slots, count = _clip_polygons(slots, count, voxel_f)
    weight, uv_u, uv_v = _area_uv(slots, count)
    return weight, torch.stack([uv_u, uv_v], dim=-1)
