"""K1: one fused voxelization pass with ordered compaction
(csrc/fused_pass.cu).

The counterpart of obj2voxel_tpu/ops/pass_fused.py `fused_pass_pallas` with
`pack=True`.  Rows [r0, r0 + n_rows) of the plan-ordered (M, 24) triangle
table each own `expand` = 2^k pair slots; slot s belongs to row s >> k and
has within-AABB rank local_base + (s & (2^k-1)).
Per slot: the row's voxel AABB (x/y clamped to [0, stride), z to
[z_lo, z_hi)), the rank decoded to a voxel, the six-plane clip with the
clipped area as weight, the key (vz - z_lo) * stride^2 + vy * stride + vx
and the premultiplied channels (w, w*r, w*g, w*b).  The live pairs (w > 0)
come back compacted in slot order with an exact count.

`wide_local` passes (giant triangles whose rank can reach 2^23) decode the
rank with exact integer div/mod (obj2voxel_tpu/engine.py:466-470); all
others use the float-reciprocal divmod of the TPU kernel.

With `ref_weights` (the TPU kernel's variant, the engine's input-area
weights) every occupied voxel weighs the area of its whole table triangle,
`triangle_area`, instead of the clipped piece's.

With `textured` (the TPU kernel's variant of the same name) the clip also
carries the UVs, and a live pair's channels are (w, u, v, row): the clipped
piece's area-weighted UV centroid in place of the premultiplied color, and,
where the TPU kernel writes zeros, the pair's table row as int32, so that
the texture sampling finds the row's type, color and texture id.  Both flags
combine.

`fused_pass_batch` is the TPU kernel's batched form (`nbatch` > 1,
obj2voxel_tpu/engine.py `_bucket_pass_batch`): up to MAX_BATCH untextured,
non-`wide_local` passes that share expand, budget, stride and ref_weights;
row b's first counts[b] entries are pass b's `fused_pass` output, bit for
bit.  For CUDA tensors both wrappers make one launch of the one kernel
(csrc/fused_pass.cu, after a memset of its look-back status words):
`fused_pass` is its launch of one pass, as `fused_pass_pallas` is the TPU
kernel's nbatch = 1.  The kernel leaves the rows past a count undefined (the
TPU kernel's pack mode does too), so a caller reads only `[:count]`.

For CPU tensors the wrappers take the plain versions: `fused_pass_ref`,
built from the XLA branch of obj2voxel_tpu/engine.py `_bucket_pass` and
ops/clip.py, and `fused_pass_batch_ref`, which stacks it over the passes;
both fill the rows past a count with (INVALID, 0).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .clip import _sqrt_rn, clip_channels


#: Passes one batched launch takes at most (csrc/fused_pass.cu kMaxBatch).
MAX_BATCH = 8


def _divmod_f(lf, sf):
    """Float-reciprocal divmod with one correction step: exact for
    0 <= lf < 2^23."""
    q = torch.floor(lf * (1.0 / sf))
    r = lf - q * sf
    q = torch.where(r < 0, q - 1.0, torch.where(r >= sf, q + 1.0, q))
    return lf - q * sf, q


def triangle_area(t):
    """0.5 * |e1 x e2| of channel-major triangles t (>= 9, N) (rows 0..8 the
    vertex coordinates), in obj2voxel_tpu/ops/pass_fused.py:191-197's
    order: the weight of an occupied voxel under input-area weights."""
    e1x, e1y, e1z = t[3] - t[0], t[4] - t[1], t[5] - t[2]
    e2x, e2y, e2z = t[6] - t[0], t[7] - t[1], t[8] - t[2]
    cx = e1y * e2z - e1z * e2y
    cy = e1z * e2x - e1x * e2z
    cz = e1x * e2y - e1y * e2x
    return 0.5 * _sqrt_rn(cx * cx + cy * cy + cz * cz)


def slot_voxels(rows, row, local, z_lo, z_hi, stride, wide_local):
    """The voxel of each slot and whether it lies in its row's AABB.

    rows: (R, 24) table rows; row, local: (S,) int64 row index into `rows`
    and within-AABB rank of each slot.  The per-row voxel AABB is x/y
    clamped to [0, stride) and z to [z_lo, z_hi), with the planner's float
    ops.  Returns (vx, vy, vz (S,) int64, inside (S,) bool); the voxel of a
    slot outside its AABB is meaningless."""
    tmin, size = [], []
    los = (0, 0, z_lo)
    his = (stride, stride, z_hi)
    for a in range(3):
        va = torch.minimum(torch.minimum(rows[:, a], rows[:, a + 3]), rows[:, a + 6])
        vb = torch.maximum(torch.maximum(rows[:, a], rows[:, a + 3]), rows[:, a + 6])
        t_lo = torch.clamp(torch.floor(va).to(torch.int64), los[a], his[a])
        t_hi = torch.clamp(torch.floor(vb).to(torch.int64) + 1, los[a], his[a])
        tmin.append(t_lo[row])
        size.append(torch.clamp(t_hi - t_lo, min=0)[row])
    sx = torch.clamp(size[0], min=1)
    sy = torch.clamp(size[1], min=1)
    inside = local < size[0] * size[1] * size[2]
    if wide_local:
        rest = local // sx
        vx = tmin[0] + local % sx
        vy = tmin[1] + rest % sy
        vz = tmin[2] + rest // sy
    else:
        mx, rest = _divmod_f(local.to(torch.float32), sx.to(torch.float32))
        my, mz = _divmod_f(rest, sy.to(torch.float32))
        vx = tmin[0] + mx.to(torch.int64)
        vy = tmin[1] + my.to(torch.int64)
        vz = tmin[2] + mz.to(torch.int64)
    return vx, vy, vz, inside


def fused_pass_ref(table, r0, n_rows, local_base, z_lo, z_hi, stride, *,
                   expand, budget, wide_local, ref_weights=False,
                   textured=False):
    """Plain version of the pass; same contract as `fused_pass`."""
    dev = table.device
    rows = table[r0 : r0 + n_rows]
    slot = torch.arange(n_rows * expand, dtype=torch.int64, device=dev)
    row = slot // expand
    local = local_base + (slot & (expand - 1))
    vx, vy, vz, keep = slot_voxels(rows, row, local, z_lo, z_hi, stride,
                                   wide_local)
    # only slots inside their row's AABB volume can be live; the rest clip
    # to zero weight, so they are never clipped here
    row, vx, vy, vz = row[keep], vx[keep], vy[keep], vz[keep]

    vox = torch.stack([vx, vy, vz]).to(torch.float32)
    w, u, v = (x[0] for x in clip_channels(rows[row, 0:16].T, vox))
    if ref_weights:
        w = torch.where(w > 0, triangle_area(rows[:, 0:9].T)[row], 0.0)
    live = w > 0
    n = int(live.sum())
    w, row = w[live], row[live]
    key = ((vz - z_lo) * (stride * stride) + vy * stride + vx)[live]
    if textured:
        chans = (w, u[live], v[live], (r0 + row).to(torch.int32))
    else:
        rgb = rows[row, 17:20]
        chans = (w, w * rgb[:, 0], w * rgb[:, 1], w * rgb[:, 2])

    out_k = torch.full((budget,), _cuda.INVALID_KEY, dtype=torch.int32, device=dev)
    out_k[:n] = key.to(torch.int32)
    outs = []
    for c in chans:
        o = torch.zeros(budget, dtype=c.dtype, device=dev)
        o[:n] = c
        outs.append(o)
    count = torch.tensor([n], dtype=torch.int32, device=dev)
    return (out_k, *outs, count)


def _check(table, r0, n_rows, local_base, z_lo, z_hi, stride, expand, budget,
           wide_local):
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] != 24:
        raise ValueError("fused_pass: table must be a (M, 24) float32 tensor")
    if expand < 1 or expand & (expand - 1) or budget % expand:
        raise ValueError(f"fused_pass: bad expand {expand} for budget {budget}")
    if not 0 < budget < 1 << 31:
        raise ValueError(f"fused_pass: bad budget {budget}")
    if not 0 <= n_rows <= budget // expand:
        raise ValueError(f"fused_pass: {n_rows} rows exceed the budget")
    if r0 < 0 or r0 + n_rows > table.shape[0]:
        raise ValueError("fused_pass: row range outside the table")
    if not 0 <= z_lo <= z_hi or stride <= 0:
        raise ValueError("fused_pass: bad slab bounds")
    if (z_hi - z_lo) * stride * stride >= 1 << 31:
        raise ValueError("fused_pass: slab keys overflow int32")
    if local_base < 0 or local_base + budget > 1 << 31:
        raise ValueError("fused_pass: slot rank overflows int32")
    if not wide_local and local_base + expand > 1 << 23:
        raise ValueError("fused_pass: float rank decode needs ranks < 2^23")


def fused_pass(table, r0, n_rows, local_base, z_lo, z_hi, stride, *, expand,
               budget, wide_local=False, ref_weights=False, textured=False):
    """Run one pass over table rows [r0, r0 + n_rows); `ref_weights` weighs
    each occupied voxel by its whole triangle's area.

    Returns (key (budget,) int32, w, wr, wg, wb (budget,) float32, count (1,)
    int32): the live pairs in slot order, then (INVALID, 0) on the CPU and
    undefined rows on CUDA.  With `textured`, (key, w, u, v (budget,)
    float32, row (budget,) int32, count)."""
    r0, n_rows, local_base = int(r0), int(n_rows), int(local_base)
    z_lo, z_hi, stride = int(z_lo), int(z_hi), int(stride)
    _check(table, r0, n_rows, local_base, z_lo, z_hi, stride, expand, budget,
           wide_local)
    if table.device.type == "cpu":
        return fused_pass_ref(table, r0, n_rows, local_base, z_lo, z_hi, stride,
                              expand=expand, budget=budget,
                              wide_local=wide_local, ref_weights=ref_weights,
                              textured=textured)
    return _launch("fused_pass", table, [(r0, n_rows, local_base, z_lo, z_hi,
                                          stride)], expand, budget, wide_local,
                   ref_weights, textured)


def fused_pass_batch_ref(table, passes, *, expand, budget, ref_weights=False):
    """Plain version of the batched pass: `fused_pass_ref` over each pass,
    stacked; same contract as `fused_pass_batch`."""
    outs = [fused_pass_ref(table, *p, expand=expand, budget=budget,
                           wide_local=False, ref_weights=ref_weights)
            for p in passes]
    return (*(torch.stack([o[j] for o in outs]) for j in range(5)),
            torch.cat([o[5] for o in outs]))


def _check_batch(table, passes, expand, budget):
    if not 1 <= len(passes) <= MAX_BATCH:
        raise ValueError(f"fused_pass_batch: {len(passes)} passes, not 1 to "
                         f"{MAX_BATCH}")
    if any(len(p) != 6 for p in passes):
        raise ValueError("fused_pass_batch: a pass is (r0, n_rows, local_base, "
                         "z_lo, z_hi, stride)")
    if len({p[5] for p in passes}) != 1:
        raise ValueError("fused_pass_batch: the passes mix strides")
    for p in passes:
        _check(table, *p, expand, budget, False)


def fused_pass_batch(table, passes, *, expand, budget, ref_weights=False):
    """Run len(passes) <= MAX_BATCH untextured passes of one shape in one
    launch.  Each pass is `fused_pass`'s (r0, n_rows, local_base, z_lo, z_hi,
    stride), all with the same stride, at `expand` and `budget` and never
    `wide_local`.

    Returns (key (B, budget) int32, w, wr, wg, wb (B, budget) float32,
    counts (B,) int32): row b's first counts[b] entries are what `fused_pass`
    gives for pass b; the entries past the count are undefined."""
    passes = [tuple(int(x) for x in p) for p in passes]
    _check_batch(table, passes, expand, budget)
    if table.device.type == "cpu":
        return fused_pass_batch_ref(table, passes, expand=expand, budget=budget,
                                    ref_weights=ref_weights)
    nb = len(passes)
    out = _launch("fused_pass_batch", table, passes, expand, budget, False,
                  ref_weights, False)
    return (*(x.view(nb, budget) for x in out[:5]), out[5])


def _launch(name, table, passes, expand, budget, wide_local, ref_weights,
            textured):
    """One launch of the CUDA kernel over `passes` (checked, all of one
    stride): (key, 4 channels (B * budget,), counts (B,)), pass b's rows at
    b * budget; the fourth channel of a textured launch is the rows'
    int32."""
    dev = _cuda.require_cuda(name, table)
    nb = len(passes)
    size = nb * budget
    n_tiles = -(-budget // _cuda.COMPACT_TILE)
    # one buffer: the outputs ((B, budget) key and 4 channels, then the (B,)
    # counts), then, 8-byte aligned, the (B, tiles) look-back status words
    # and the ticket, which the launcher zeroes
    head = 5 * size + nb + nb % 2
    out = torch.empty(head + 2 * (nb * n_tiles + 1), dtype=torch.int32, device=dev)
    key = out[:size]
    chans = [out[(i + 1) * size:(i + 2) * size] for i in range(4)]
    chans = [c if textured and i == 3 else c.view(torch.float32)
             for i, c in enumerate(chans)]
    counts = out[5 * size:5 * size + nb]
    # (r0, n_rows, local_base, z_lo, z_hi) a pass, by value into the launch
    scal = (ctypes.c_int * (5 * nb))(*(x for p in passes for x in p[:5]))
    op = out.data_ptr()
    err = _cuda.lib().o2v_fused_pass(
        *(op + 4 * i * size for i in range(6)), op + 4 * head,
        table.data_ptr(), table.shape[0], scal, nb, passes[0][5],
        expand.bit_length() - 1, budget, int(bool(wide_local)),
        int(bool(ref_weights)), int(bool(textured)), _cuda.stream_ptr(dev),
    )
    _cuda.check(err, name)
    _cuda.count_launch("fused_pass")
    return (key, *chans, counts)
