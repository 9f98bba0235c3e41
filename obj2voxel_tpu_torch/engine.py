"""Voxelization pipeline driver in PyTorch.

The port of obj2voxel_tpu/engine.py's single-device path:

  host:   bounds -> transform -> subdivide -> (N, 24) triangle table
  device: plan (ops/plan_device.py) -> one plan-order gather -> per-bucket
          passes -> per-slab merges (stable key sort -> `combine_pack`:
          K2's segmented combine and K3's exact compaction in one pass)
          -> finalize to (xyz, ARGB) per z-slab

Every pass runs K1 (ops/pass_fused.py: expansion, rank decode, clip, key,
premultiply, ordered compaction in one kernel), which returns its live pairs
in slot order and their count; nothing reads a pass's rows past its count.
A mesh whose texture pool holds more than one pixel takes K1's textured
variant (the JAX package's choice, obj2voxel_tpu/engine.py:1250-1251,
:503): the same pass with UVs, each live pair carrying its table row, and
once the counts are read back, `_textured_pass` samples and premultiplies
the live pairs' colors in torch ops.
With input-area weights (`input_area_weights`, or O2V_WEIGHT_MODE=input_area)
an occupied voxel weighs its whole triangle's area instead of the clipped
piece's (obj2voxel_tpu/engine.py:488-501).

Merges (`_merge_slab`).  By default every slab takes one merge tail: a
stable sort of the slot-ordered pass outputs equals the stable sort of the
full pair stream, so MAX ties go to the earliest pair.  With `merge_runs`
(or O2V_MERGE_RUNS=1; off by default, as in the JAX package) each pass's
live pairs are first stable-sorted by key, and a slab of 2 to 32 runs
merges them with K6 instead of sorting the concatenation; a single run goes
straight to `combine_pack`, more than 32 take the sort.  Equal keys arrive in
(pass, slot) order either way, so the two routes give the same bytes.

2x supersampling (`do_down`) samples at twice the resolution and halves
each axis in the merge (obj2voxel_tpu/engine.py:233-264, :629-647): a
single-pass slab combines at the fine resolution, downscales the combined
keys, and combines again; a multi-pass slab stable-sorts each pass by fine
key, concatenates, downscales and combines once.  So a supersampled MAX tie
goes to the earlier pass, then the earlier fine key, then the earlier slot
(the JAX package on the CPU gives the same; its TPU default, whose passes
stay in slot order, would break a within-pass tie by slot).  Slab heights
are even, so no 2x2x2 cell straddles two slabs.  Supersampling bypasses the
merge-runs route, as in the JAX package: its merge sorts after the
downscale.

Batched passes (O2V_BATCH, obj2voxel_tpu/engine.py:1174-1305; off by
default, as in the JAX package).  With O2V_BATCH=B > 1, on a CUDA device
(or anywhere under O2V_BATCH_FORCE=1) and for an untextured mesh, the
passes of a wave's multi-pass slabs that are not `wide_local` and whose
budget is a multiple of BATCH_BLOCK group by (expand, budget), in sorted
order, into launches of K1's batched form (`fused_pass_batch`) of 8, 4 or
2 passes up to B; a lone remainder runs as a launch of one pass.  Passes of
different slabs batch together.  Each slab still merges its passes in pass
order, so the output is the unbatched one, byte for byte.  `WAVE_STATS`
counts the last call's passes, dispatches and batched passes, its slabs,
waves and plan-order rows, and says which planner planned it.

Knobs, read as the JAX package reads them: O2V_MAX_PASS_BUDGET (at import:
MAX_PASS_BUDGET), and per `stream_slabs` call O2V_WAVE_CAP (slots in
flight a wave), O2V_HOST_PLAN=1 (plan on the host), O2V_GROUP (triangles
per planning unit), O2V_BATCH, O2V_BATCH_FORCE and O2V_TIMING=1
(`[o2v-timing]` lines on stdout: the host prep, the table and its upload
(a batch's whole prep on the device), the plan, each wave, its merges and
its pulls, and in `api.Instance` the input's load and the writer;
`TIMING_S` sums their seconds by stage).

Batch mode (`voxelize_batch`, obj2voxel_tpu/engine.py:1501-1587) stacks many
small meshes along z, each normalized to its own grid, into one
`stream_slabs` stream, and splits the output by mesh once, after it (a
stack with more than MAX_DEVICE_SLABS slabs is planned on the host).  Its
host prep and table are built on the device for every mesh at once
(ops/batch_prep.py), bit for bit what `prepare_soup` a mesh, the z stack
and `host_table` give; `PREP_STATS` counts the last call's.
`stream_slabs(z_window=...)` streams one window of the grid, for
parallel/mesh.py.

The device defaults to CUDA; on a CPU tensor each kernel wrapper takes its
plain version, on a CUDA tensor it launches the hand-written kernel.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .constants import BLEND_STRATEGY, MAX_STRATEGY, PAIR_TILE
from .geometry import compute_mesh_transform, mesh_bounds
from .io import debug_stl
from .ops.batch_prep import batch_table
from .ops.color import sample_pair_colors_uv, upload_pool
from .ops.combine import (
    downscale_keys, finalize_colors, pack_argb, sort_channels,
)
from .ops.combine_pallas import combine_pack
from .ops.merge_pallas import MAX_RUNS, merge_runs as merge_sorted_runs, plan_runs
from .ops.pass_fused import fused_pass, fused_pass_batch
from .ops.plan import plan_mesh
from .ops.plan_device import gather_ordered, hist_in_smem, plan_mesh_device
from .ops.subdivide import subdivide_soup
from .soup import TexturePool, TriangleSoup, build_tri_table, pow2_at_least
from .utils import debug as _dbg
from .utils.log import log as _log

__all__ = [
    "MAX_PASS_BUDGET", "PREP_STATS", "TriangleSoup", "WAVE_STATS",
    "build_tri_table", "densify", "plan_fold_chunks", "stream_slabs",
    "voxelize_batch", "voxelize_grid", "voxelize_soup",
]

#: Maximum pair slots per pass (the effective budget is
#: min(pair_tile, max_pass_budget)); O2V_MAX_PASS_BUDGET sets it at import.
MAX_PASS_BUDGET = int(os.environ.get("O2V_MAX_PASS_BUDGET", 1 << 21))

#: Allowed pass sizes; the scheduler covers each segment greedily with full
#: rungs (obj2voxel_tpu/engine.py BUDGET_LADDER).
BUDGET_LADDER = (1 << 14, 1 << 17, 1 << 21, 1 << 22, 1 << 23)

#: Rows above which a slab's pass outputs are folded in groups before the
#: final merge (a memory bound on the merge's sort).
MERGE_CAP = 1 << 25

#: Pass slots dispatched per wave before the counts are read back (a memory
#: bound: each slot holds 20 bytes until the slab merges, a batched pass's
#: until every slab of its launch merges); O2V_WAVE_CAP sets it per call.
WAVE_CAP_ROWS = 1 << 27

#: Triangles per planning unit for the device planner; O2V_GROUP sets it
#: per call.
PLAN_GROUP = 8

#: A batched pass's budget is a multiple of this: the JAX package's gate,
#: the TPU kernel's block (obj2voxel_tpu/ops/pass_fused.py BLOCK).
BATCH_BLOCK = 8192

#: The last `stream_slabs` call's passes, dispatches (single passes and
#: batched launches) and passes run batched (obj2voxel_tpu/engine.py
#: WAVE_STATS), and, beyond the JAX package's keys, its slabs, its waves,
#: its plan-order rows, whether the host planner planned it (1) or the
#: device planner (0), and whether the device planner's histogram kernel
#: summed in block-private shared memory (1; ops/plan_device.hist_in_smem);
#: not thread-safe, like the JAX package's.
WAVE_STATS = {"passes": 0, "dispatches": 0, "batched": 0, "slabs": 0, "waves": 0,
              "rows": 0, "host_plan": 0, "hist_smem": 0}

#: The last `voxelize_batch` call's prep on the device (ops/batch_prep.py):
#: meshes prepared in bulk, triangles in and out of the subdivision, its
#: checks (a round's split test, the last finding none), and the device.
PREP_STATS = {"meshes": 0, "triangles_in": 0, "triangles_out": 0, "rounds": 0,
              "device": ""}

#: Under O2V_TIMING=1, the host seconds of each `[o2v-timing]` stage (load,
#: prepare, table, plan, passes, merges, pulls, write), summed over the
#: lines printed since the caller last cleared it.
TIMING_S: dict[str, float] = {}


def timing_line(stage: str, seconds: float, text: str):
    """Print one `[o2v-timing]` line and add `seconds` to TIMING_S[stage]."""
    TIMING_S[stage] = TIMING_S.get(stage, 0.0) + seconds
    print(f"[o2v-timing] {text}", flush=True)


def _chunk_budget(remaining_slots: int, expand: int, max_budget: int) -> int:
    """The smallest ladder rung covering the remaining slots, else the
    largest usable one; rungs below `expand` cannot host one row."""
    usable = [b for b in BUDGET_LADDER if expand <= b <= max_budget]
    if not usable:
        return max_budget
    for b in usable:
        if b >= remaining_slots:
            return b
    return usable[-1]


def _schedule_passes(segments, max_budget):
    """Turn one slab's segments into (expand, budget, r0, n_rows,
    local_base, wide_local) pass descriptors.  Buckets wider than the budget
    (giant axis-aligned triangles) get one row per pass, walking the slot
    domain budget slots at a time with the exact integer rank decode."""
    passes = []
    for seg in segments:
        if (1 << seg.k) <= max_budget:
            r = seg.r0
            while r < seg.r1:
                remaining = seg.r1 - r
                budget = _chunk_budget(remaining << seg.k, 1 << seg.k, max_budget)
                rows = min(max(1, budget >> seg.k), remaining)
                passes.append((1 << seg.k, budget, r, rows, 0, False))
                r += rows
        else:
            budget = max_budget
            n_sub = -(-(1 << seg.k) // budget)
            for row in range(seg.r0, seg.r1):
                for j in range(n_sub):
                    passes.append((budget, budget, row, 1, j * budget, True))
    return passes


def _waves(slab_list, stride, max_budget, wave_cap, batch_cap):
    """The host schedule of `stream_slabs`, one wave at a time: a wave
    takes slabs until their passes' budgets reach `wave_cap` (and at least
    one).  Yields (slabs, dispatches): slabs [(z_lo, z_hi, n_passes)];
    dispatches [(expand, budget, wide_local, [(slab, pass, desc)])] in
    dispatch order, desc being `fused_pass`'s (r0, n_rows, local_base, z_lo,
    z_hi, stride).  Each pass that cannot batch runs alone, in wave order;
    then, when batch_cap > 1, the passes of multi-pass slabs that are not
    `wide_local` and whose budget is a multiple of BATCH_BLOCK group by
    (expand, budget) in sorted order and are cut into launches of 8, 4 or 2
    passes up to batch_cap, a lone remainder alone
    (obj2voxel_tpu/engine.py:1210-1305)."""
    i = 0
    while i < len(slab_list):
        slabs, dispatches, groups, rows = [], [], {}, 0
        while i < len(slab_list) and (not slabs or rows < wave_cap):
            (z_lo, z_hi), segs = slab_list[i]
            i += 1
            passes = _schedule_passes(segs, max_budget)
            for pi, (expand, budget, r0, n_rows, local_base, wide) in enumerate(passes):
                item = (len(slabs), pi, (r0, n_rows, local_base, z_lo, z_hi, stride))
                if (batch_cap > 1 and len(passes) > 1 and not wide
                        and budget % BATCH_BLOCK == 0):
                    groups.setdefault((expand, budget), []).append(item)
                else:
                    dispatches.append((expand, budget, wide, [item]))
                rows += budget
            slabs.append((z_lo, z_hi, len(passes)))
        for (expand, budget), items in sorted(groups.items()):
            j = 0
            while j < len(items):
                size = next((c for c in (8, 4, 2)
                             if c <= batch_cap and j + c <= len(items)), 1)
                dispatches.append((expand, budget, False, items[j:j + size]))
                j += size
        yield slabs, dispatches


def plan_fold_chunks(sizes, cap):
    """Partition indices [0, len) into consecutive groups whose size sums
    stay <= cap (a group always takes at least one item)."""
    groups, cur, acc = [], [], 0
    for i, s in enumerate(sizes):
        if cur and acc + s > cap:
            groups.append(cur)
            cur, acc = [], 0
        cur.append(i)
        acc += s
    if cur:
        groups.append(cur)
    return groups


def _textured_pass(table, pool, w, u, v, row):
    """The colors of a textured pass's live pairs (obj2voxel_tpu/engine.py:
    410-524, the unfused branch of `_bucket_pass`): K1's textured variant
    gave each pair its weight, UV centroid and table row; its color is
    sampled from the pool by the row's type, color and texture id and
    premultiplied.  `table` is the plan-ordered (M, 24) table; w, u, v, row
    are the pass's first `count` rows.  Returns (w, wr, wg, wb)."""
    # columns 16:21 (type, r, g, b, texture id) of each pair's row
    attrs = table[:, 16:21].index_select(0, row).T
    colors = sample_pair_colors_uv(
        u, v, attrs[0].to(torch.int64), attrs[1:4].T, attrs[4].to(torch.int64),
        *pool,
    )
    # premultiply in place of the spent u, v and rows: the pass's outputs
    # stay the one buffer K1 wrote until the slab merges (a wave holds tens
    # of passes)
    wr, wg, wb = u, v, row.view(torch.float32)
    for c, out in enumerate((wr, wg, wb)):
        torch.mul(w, colors[:, c], out=out)
    return w, wr, wg, wb


def _merge_keys(keys, chans, is_blend):
    """Stable sort -> `combine_pack`: compacted unique (keys, chans, count
    (1,)) in slab-local key order."""
    return combine_pack(*sort_channels(keys, chans), is_blend)


def _cat(runs):
    """Concatenate (keys, chans) runs."""
    keys = torch.cat([x[0] for x in runs])
    return keys, tuple(torch.cat([x[1][j] for x in runs]) for j in range(4))


def _fold_outputs(chunk, is_blend):
    """Merge a group of (keys, chans) pass outputs into one compacted
    output in key order, sliced to its live count."""
    k, ch, count = _merge_keys(*_cat(chunk), is_blend)
    n = int(count.item())
    return k[:n], tuple(c[:n] for c in ch)


def _finalize_merge(keys, chans, count, z_lo, stride, do_down=False):
    """Slab-local keys -> (xyz (P, 3) int32, argb (P,) uint32, count); with
    do_down the keys are in the half-resolution grid."""
    if do_down:
        z_lo, stride = z_lo // 2, stride // 2
    k = keys.to(torch.int64)
    x = k % stride
    y = (k // stride) % stride
    z = k // (stride * stride) + z_lo
    xyz = torch.stack([x, y, z], dim=-1).to(torch.int32)
    return xyz, pack_argb(finalize_colors(chans)), count


def _merge_slab(live, n_passes, z_lo, *, is_blend, stride, do_down, merge_runs):
    """Merge one slab's live pass outputs, (keys, chans) in slot order, and
    finalize: (xyz, argb, count (1,)); rows past count are padding.  The
    routes are the module docstring's."""
    if do_down and n_passes == 1:
        # combine at the fine resolution, then downscale and combine again
        k, ch, _ = _merge_keys(*live[0], is_blend)
        k, ch, count = _merge_keys(downscale_keys(k, stride), ch, is_blend)
        return _finalize_merge(k, ch, count, z_lo, stride, do_down)
    if do_down or merge_runs:
        live = [sort_channels(k, ch) for k, ch in live]
    while sum(x[0].shape[0] for x in live) > MERGE_CAP:
        before = sum(x[0].shape[0] for x in live)
        groups = plan_fold_chunks([x[0].shape[0] for x in live], MERGE_CAP)
        if len(groups) == 1:
            break
        live = [_fold_outputs([live[j] for j in g], is_blend) for g in groups]
        if sum(x[0].shape[0] for x in live) >= before:
            break  # folding cannot shrink further
    keys, chans = _cat(live)
    if do_down:
        keys = downscale_keys(keys, stride)
    elif merge_runs and len(live) <= MAX_RUNS:
        if len(live) > 1:
            offsets, _ = plan_runs([x[0].shape[0] for x in live])
            keys, chans = merge_sorted_runs(keys, chans, offsets)
        return _finalize_merge(*combine_pack(keys, chans, is_blend), z_lo,
                               stride)
    return _finalize_merge(*_merge_keys(keys, chans, is_blend), z_lo, stride,
                           do_down)


def _pull(arr, count):
    """The first `count` rows on the host as numpy."""
    return arr[:count].cpu().numpy()


def voxelize_soup(
    soup: TriangleSoup,
    pool: TexturePool | None = None,
    *,
    resolution: int,
    device="cuda",
    supersampling: int = 1,
    strategy: int = MAX_STRATEGY,
    unit_transform=None,
    bounds=None,
    pair_tile: int = PAIR_TILE,
    max_pass_budget: int = MAX_PASS_BUDGET,
    subdivide: bool = True,
    group: int | None = None,
    merge_runs: bool | None = None,
    input_area_weights: bool | None = None,
):
    """Voxelize a triangle soup on `device` (a CUDA device unless the caller
    asks for the CPU); yields (xyz int32 (K, 3), argb uint32 (K,)) numpy
    arrays per z-slab.  `supersampling` 2 samples at twice the resolution
    and halves each axis; `merge_runs` and `input_area_weights` are
    `stream_slabs`'s."""
    device = torch.device(device)
    if len(soup) == 0:
        return
    sample_res = resolution * supersampling
    t0 = time.perf_counter()
    host = prepare_soup(soup, sample_res, unit_transform, bounds, subdivide)
    if os.environ.get("O2V_TIMING") == "1":
        dt = time.perf_counter() - t0
        timing_line("prepare", dt, f"prepare {dt * 1000:.0f}ms ({len(soup)} -> "
                    f"{host[0].shape[0]} triangles)")
    gen = voxelize_grid(
        *host, upload_pool(pool, device),
        device=device, stride=sample_res, z_extent=sample_res,
        is_blend=bool(strategy == BLEND_STRATEGY), do_down=bool(supersampling > 1),
        pair_tile=pair_tile, max_pass_budget=max_pass_budget, group=group,
        merge_runs=merge_runs, input_area_weights=input_area_weights,
    )
    del host
    yield from gen


def prepare_soup(soup, sample_res, unit_transform=None, bounds=None,
                 subdivide=True):
    """Host work of one mesh: normalize to [0, sample_res)^3 (or to
    `bounds`), then subdivide.  Returns the host arrays (verts (N, 3, 3),
    uvs, types, rgb, tex) in voxel space."""
    if bounds is None:
        mesh_min, mesh_max = mesh_bounds(soup.verts)
    else:
        mesh_min = np.asarray(bounds[0], np.float32)
        mesh_max = np.asarray(bounds[1], np.float32)
    transform = compute_mesh_transform(mesh_min, mesh_max, sample_res, unit_transform)
    verts = transform.apply(soup.verts)
    if subdivide:
        verts, uvs, tri_index = subdivide_soup(verts, soup.uvs)
        host = (verts, uvs, soup.types[tri_index], soup.rgb[tri_index],
                soup.tex[tri_index])
    else:
        host = (verts, soup.uvs, soup.types, soup.rgb, soup.tex)
    if debug_stl.enabled():
        debug_stl.record(verts)
    return host


def host_table(verts_host, uvs_host, types_host, rgb_host, tex_host, *, stride,
               z_extent):
    """The (N_pad, 24) host table of pre-transformed triangles and their
    host voxel AABBs (vmin, vmax) (x/y grid-clamped, vmax exclusive), as
    `stream_slabs` takes them."""
    clamp_hi = np.array([stride, stride, z_extent], np.float32)
    vmin_h = np.clip(np.floor(verts_host.min(axis=1)), 0, clamp_hi).astype(np.int32)
    vmax_h = np.clip(np.floor(verts_host.max(axis=1)) + 1, 0, clamp_hi).astype(np.int32)
    table = build_tri_table(verts_host, uvs_host, types_host, rgb_host, tex_host,
                            n_pad=pow2_at_least(verts_host.shape[0]))
    return table, (vmin_h, vmax_h)


def voxelize_grid(
    verts_host, uvs_host, types_host, rgb_host, tex_host, pool=None, *,
    device="cuda",
    stride: int,
    z_extent: int,
    is_blend: bool,
    do_down: bool = False,
    pair_tile: int = PAIR_TILE,
    max_pass_budget: int = MAX_PASS_BUDGET,
    group: int | None = None,
    merge_runs: bool | None = None,
    input_area_weights: bool | None = None,
):
    """Streaming loop over z-slabs for pre-transformed triangles on a grid
    spanning [0, stride) in x/y and [0, z_extent) in z.  `pool` is the
    device texture pool (ops/color.upload_pool) or None; the other options
    are `stream_slabs`'s."""
    if verts_host.shape[0] == 0:
        return
    t0 = time.perf_counter()
    table, aabb = host_table(verts_host, uvs_host, types_host, rgb_host, tex_host,
                             stride=stride, z_extent=z_extent)
    # the generator frame lives for the whole stream: keep no host copies
    del verts_host, uvs_host, types_host, rgb_host, tex_host
    table = torch.from_numpy(table).to(device)
    if os.environ.get("O2V_TIMING") == "1":
        dt = time.perf_counter() - t0
        timing_line("table", dt, f"table+upload {dt * 1000:.0f}ms "
                    f"rows={table.shape[0]}")
    yield from stream_slabs(
        table, pool, aabb_host=aabb, stride=stride,
        z_extent=z_extent, is_blend=is_blend, do_down=do_down, pair_tile=pair_tile,
        max_pass_budget=max_pass_budget, group=group, merge_runs=merge_runs,
        input_area_weights=input_area_weights,
    )


def stream_slabs(
    tri_table,
    pool=None,
    *,
    aabb_host,
    stride: int,
    z_extent: int,
    is_blend: bool,
    do_down: bool = False,
    pair_tile: int = PAIR_TILE,
    max_pass_budget: int = MAX_PASS_BUDGET,
    device_outputs: bool = False,
    group: int | None = None,
    merge_runs: bool | None = None,
    input_area_weights: bool | None = None,
    z_window: tuple[int, int] | None = None,
):
    """Slab streaming over a device-resident (N, 24) triangle table in voxel
    space.  `aabb_host` is the host (vmin, vmax) pair of per-triangle voxel
    AABBs (vmax exclusive, x/y grid-clamped) for the first len(vmin) rows.
    `pool` is the device texture pool (pixels, meta) of ops/color.upload_pool
    or None.  Like the JAX package, every pass takes K1's textured variant
    and `_textured_pass` when the pool holds more than one pixel and plain K1
    otherwise: a pool of one 1x1 texture takes plain K1, so its textured
    triangles get their flat color.

    `do_down` halves each axis in the merge (the grid is sampled at stride,
    the output is stride // 2).  `merge_runs` (default: O2V_MERGE_RUNS=1)
    takes the K6 merge route and `input_area_weights` (default:
    O2V_WEIGHT_MODE=input_area) weighs each occupied voxel by its whole
    triangle's area; both defaults are read once per call.

    `z_window` = (z0, z1), even-aligned, streams only the slabs that tile
    that range of the grid (parallel/mesh.py gives each device one).

    `group` (default: O2V_GROUP, else PLAN_GROUP) is the device planner's
    triangles per planning unit.  The batched passes and the other knobs
    are the module docstring's; the environment is read once per call.

    Yields (xyz, argb) numpy arrays per slab, or with device_outputs=True
    (xyz, argb, count) with xyz/argb still on the device, count-padded."""
    timing = os.environ.get("O2V_TIMING") == "1"
    t0 = time.perf_counter()
    if merge_runs is None:
        merge_runs = os.environ.get("O2V_MERGE_RUNS") == "1"
    if input_area_weights is None:
        input_area_weights = os.environ.get("O2V_WEIGHT_MODE") == "input_area"
    if group is None:
        group = int(os.environ.get("O2V_GROUP", PLAN_GROUP))
    wave_cap = int(os.environ.get("O2V_WAVE_CAP", WAVE_CAP_ROWS))
    batch_cap = int(os.environ.get("O2V_BATCH", 1))
    merge_runs = bool(merge_runs) and not do_down
    ref_weights = bool(input_area_weights)
    vmin_h, vmax_h = aabb_host
    n_sub = vmin_h.shape[0]
    max_budget = min(pair_tile, max_pass_budget)
    slot_budget = 4 * max_budget
    textured = pool is not None and pool[0].shape[0] > 1
    can_batch = batch_cap > 1 and not textured and (
        tri_table.device.type == "cuda"
        or os.environ.get("O2V_BATCH_FORCE") == "1")
    WAVE_STATS.update(passes=0, dispatches=0, batched=0, slabs=0, waves=0,
                      rows=0, host_plan=0, hist_smem=0)

    order = segments = None
    if os.environ.get("O2V_HOST_PLAN") != "1":
        WAVE_STATS["hist_smem"] = int(tri_table.device.type == "cuda"
                                      and hist_in_smem(z_extent))
        order, segments = plan_mesh_device(
            tri_table, n_sub, stride, z_extent, slot_budget, group=group,
            z_window=z_window,
        )
        if order is None and segments is not None:
            return  # empty mesh
    if order is None:
        # asked for, or too many slabs for the device planner: plan on the host
        order_np, segments = plan_mesh(vmin_h, vmax_h, stride, z_extent, slot_budget,
                                       z_window=z_window)
        if order_np is None:
            return
        order = torch.from_numpy(order_np.astype(np.int64)).to(tri_table.device)
        group = 1
        WAVE_STATS["host_plan"] = 1
    table = gather_ordered(tri_table, order, segments[-1].r1, group)
    del order
    if timing:
        dt = time.perf_counter() - t0
        timing_line("plan", dt, f"plan+gather {dt * 1000:.0f}ms "
                    f"rows={segments[-1].r1} segments={len(segments)}")

    by_slab: dict[tuple[int, int], list] = {}
    for seg in segments:
        by_slab.setdefault((seg.z_lo, seg.z_hi), []).append(seg)
    WAVE_STATS.update(slabs=len(by_slab), rows=segments[-1].r1)

    for slabs, dispatches in _waves(list(by_slab.items()), stride, max_budget,
                                    wave_cap, batch_cap if can_batch else 1):
        # one wave: every pass of its slabs, then ONE counts read-back
        t1 = time.perf_counter() if timing else 0.0
        # per slab and pass: K1's (key, 4 channels) and its index in the counts
        handles = [[None] * n for _, _, n in slabs]
        parts, n_counts, n_batched = [], 0, 0  # count tensors in dispatch order
        for expand, budget, wide, items in dispatches:
            kw = dict(expand=expand, budget=budget, ref_weights=ref_weights)
            if len(items) == 1:
                out = fused_pass(table, *items[0][2], wide_local=wide,
                                 textured=textured, **kw)
                rows = [out[:5]]
            else:
                out = fused_pass_batch(table, [d for _, _, d in items], **kw)
                rows = [tuple(x[b] for x in out[:5]) for b in range(len(items))]
                n_batched += len(items)
            for b, (slab, pi, _) in enumerate(items):
                handles[slab][pi] = (rows[b], n_counts + b)
            parts.append(out[5])
            n_counts += len(items)
        n_wave_passes = sum(n for _, _, n in slabs)
        WAVE_STATS["passes"] += n_wave_passes
        WAVE_STATS["dispatches"] += len(dispatches)
        WAVE_STATS["batched"] += n_batched
        WAVE_STATS["waves"] += 1

        t_disp = time.perf_counter() if timing else 0.0
        counts = torch.cat(parts).tolist()
        del parts
        if timing:
            t2 = time.perf_counter()
            timing_line("passes", t2 - t1,
                        f"  wave: {len(slabs)} slabs {n_wave_passes} passes "
                        f"({len(dispatches)} dispatches, {n_batched} batched) "
                        f"{(t2 - t1) * 1000:.0f}ms (dispatch "
                        f"{(t_disp - t1) * 1000:.0f}ms, drain+pull "
                        f"{(t2 - t_disp) * 1000:.0f}ms) counts={counts}")
            t1 = t2
        merged = []
        for (z_lo, z_hi, n_passes), slab_handles in zip(slabs, handles):
            # the slab's passes in pass order, whatever their dispatch order
            live = []
            for (key, *chans), ci in slab_handles:
                c = counts[ci]
                if _dbg.DEBUG:
                    _dbg.check_count(c, key.shape[0], "pass")
                if c:
                    chans = tuple(x[:c] for x in chans)
                    if textured:
                        chans = _textured_pass(table, pool, *chans)
                    live.append((key[:c], chans))
            # a batched launch's buffer lives until its last slab merges
            slab_handles.clear()
            if live:
                merged.append((z_lo, z_hi, _merge_slab(
                    live, n_passes, z_lo, is_blend=is_blend, stride=stride,
                    do_down=do_down, merge_runs=merge_runs)))
            del live

        t_mdisp = time.perf_counter() if timing else 0.0
        mcounts = (
            torch.cat([m[2][2] for m in merged]).tolist() if merged else []
        )
        if timing and merged:
            t3 = time.perf_counter()
            timing_line("merges", t3 - t1,
                        f"  {len(merged)} merges {(t3 - t1) * 1000:.0f}ms "
                        f"(dispatch {(t_mdisp - t1) * 1000:.0f}ms, "
                        f"drain+pull {(t3 - t_mdisp) * 1000:.0f}ms)")
        t_pull = 0.0
        for (z_lo, z_hi, (xyz, argb, _)), count in zip(merged, mcounts):
            _log.spam(f"Voxelized slab z[{z_lo},{z_hi}) -> {count}")
            if _dbg.DEBUG:
                half = 2 if do_down else 1
                _dbg.check_count(count, xyz.shape[0], "merge")
                _dbg.check_slab_output(
                    _pull(xyz, count), _pull(argb, count), count,
                    res_xy=stride // half, z_extent=z_extent // half,
                    z_lo=z_lo // half, z_hi=z_hi // half,
                )
            if count:
                if device_outputs:
                    yield xyz, argb, count
                else:
                    t4 = time.perf_counter()
                    out = _pull(xyz, count), _pull(argb, count)
                    t_pull += time.perf_counter() - t4
                    yield out
        if timing and merged and not device_outputs:
            timing_line("pulls", t_pull, f"  {len(merged)} pulls "
                        f"{t_pull * 1000:.0f}ms")


def voxelize_batch(
    soups,
    pool: TexturePool | None = None,
    *,
    resolution: int,
    device="cuda",
    supersampling: int = 1,
    strategy: int = MAX_STRATEGY,
    pair_tile: int = PAIR_TILE,
    max_pass_budget: int = MAX_PASS_BUDGET,
):
    """Voxelize many small meshes in one device stream (3D-ML dataset
    generation; obj2voxel_tpu/engine.py:1501-1579).

    Each mesh is normalized to its own [0, r_s)^3 grid (r_s = resolution *
    supersampling) and subdivided, then mesh i is moved to z in
    [i r_s, (i + 1) r_s) by adding i r_s to z in float32, the JAX package's
    op: far up the stack that rounds, so a mesh's voxels in a batch need
    not be its voxels alone.  All of it runs on `device` for every mesh at
    once (ops/batch_prep.py: the per-mesh `prepare_soup`, the stack and
    `host_table`, bit for bit), and builds the stacked table there.  One
    `stream_slabs` stream covers the stack, and its output is split by mesh
    once, after the stream.  Returns one (xyz (K, 3) int32, argb (K,)
    uint32) per mesh, in that mesh's own grid and in stream order; an empty
    mesh keeps its slot with no voxels."""
    sample_res = resolution * supersampling
    device = torch.device(device)
    PREP_STATS.update(meshes=0, triangles_in=0, triangles_out=0, rounds=0,
                      device=str(device))
    t0 = time.perf_counter()
    prep = batch_table(soups, sample_res, device)
    if prep is None:
        return [(np.zeros((0, 3), np.int32), np.zeros((0,), np.uint32))
                for _ in soups]
    table, aabb, stats = prep
    del prep
    PREP_STATS.update(stats)
    if os.environ.get("O2V_TIMING") == "1":
        dt = time.perf_counter() - t0
        timing_line("table", dt, f"batch prep+table {dt * 1000:.0f}ms "
                    f"rows={table.shape[0]} {PREP_STATS}")
    stream = stream_slabs(
        table, upload_pool(pool, device), aabb_host=aabb, stride=sample_res,
        z_extent=len(soups) * sample_res, is_blend=bool(strategy == BLEND_STRATEGY),
        do_down=bool(supersampling > 1), pair_tile=pair_tile,
        max_pass_budget=max_pass_budget,
    )
    # only the stream's generator frame holds the table from here on
    del table, aabb
    return split_by_mesh(list(stream), len(soups), resolution)


def split_by_mesh(batches, n_meshes, extent):
    """Split a stacked stream's (xyz, argb) batches into one (xyz, argb) per
    mesh, mesh i owning z in [i extent, (i + 1) extent), with z made
    mesh-local.  The slabs stream in z order and each slab's rows in key
    (z-major) order, so mesh ids never decrease along the concatenated
    stream: the split is a cut at each mesh's first row, and every mesh
    keeps stream order."""
    xyz = np.concatenate([b[0] for b in batches] or [np.zeros((0, 3), np.int32)])
    argb = np.concatenate([b[1] for b in batches] or [np.zeros((0,), np.uint32)])
    mesh_id = xyz[:, 2] // extent
    if (mesh_id[1:] < mesh_id[:-1]).any():
        raise RuntimeError("split_by_mesh: the stream is not in z order")
    xyz[:, 2] -= mesh_id * extent
    cuts = np.searchsorted(mesh_id, np.arange(1, n_meshes))
    return list(zip(np.split(xyz, cuts), np.split(argb, cuts)))


def densify(xyz: np.ndarray, argb: np.ndarray, resolution: int) -> np.ndarray:
    """Sparse voxel list -> dense (r, r, r) uint32 ARGB grid (0 = empty)."""
    grid = np.zeros((resolution,) * 3, np.uint32)
    if xyz.shape[0]:
        grid[xyz[:, 0], xyz[:, 1], xyz[:, 2]] = argb
    return grid
