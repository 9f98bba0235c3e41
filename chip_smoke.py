"""Smoke test of the PyTorch port on one NVIDIA GPU.

Builds the hand-written CUDA kernels from obj2voxel_tpu_torch/csrc, holds
each against its plain PyTorch version on the card, drives the main paths
at real size -- `stream_slabs` on the 2M-triangle sphere at 1024^3,
untextured BLEND as bench.py runs it, the same table textured (one 4096^2
REPEAT texture; K1's textured passes) under MAX, the untextured table
through the merge-runs route (K6), and the table at 2048^3 supersampled
down to 1024^3 under MAX (the CLI's `-r 1024 -u`); 1000 small meshes
through `voxelize_batch`; the sphere as a soup through `stream_sharded` in
z windows repeated on the one card; the C shim; the sphere, the
supersampled sphere and the 1000 meshes again with K1's batched form
(O2V_BATCH=8); the bench entry (bench.py's counterpart) on the 2M and 10M
spheres; BASELINE configs 4 and 6 (a 10M-triangle STL into VL32 at 2048^3,
a helix at 8192^3 planned on the host) through `Instance` -- and checks
the outputs against known voxel counts and digests, the default route, one
device, the unbatched run, the CPU run of the same code, and the closed
forms.

    python3 chip_smoke.py             # all phases; needs one CUDA device
    python3 chip_smoke.py --phases 1,13

Phases: 1 build (with ptxas's registers, stack frame, spills and shared
memory of every kernel); 2 K1 (and its input-area and textured variants),
3 K2, 4 K3, 16 their fusion combine_pack, 9 K4, 10 K5, 13 K6 against
their plain versions; 5 untextured
end to end (with the merge-runs route, supersampling 2 and input-area
weights) and 11 textured, card against CPU; 6 the unit-cube closed forms;
7 untextured, 12 textured, 14 merge-runs and 15 supersampled real size; 17
batch (BASELINE config 5), 18 multi-device windows against one device, 19
the C shim's capi_test on the card (9 also runs K4 through the public
`clip_triangles_to_voxels_pallas`); 20 K1's batched form against its plain
version and against single K1 launches on the sphere's batched passes (the
counts and each pass's live rows: batches of 2 to 8, one with an empty pass,
50 launches alike; no ptxas spill, at most 64 registers), then the sphere, the supersampled sphere
and the batch under O2V_BATCH=8 against O2V_BATCH=1, timed in turns; 21
the bench entry's device, pull and host modes on the 2M sphere and device
and pull on the 10M sphere at 1024^3 (each mode's bench.py JSON line after
`[bench]`); 22 config 4 against the CPU run's bytes, then from the host
planner and from 3 z windows; 23 config 6 against the CPU run's bytes, past
32 slabs, its peak RSS under config 4's (each config's scale_proof.py JSON
line after `[scale]`); 8 kernel timings beside each kernel's bound.  Prints one line per phase, a
JSON line with the kernels' launches, errors, times and bounds, and as its
last line {"ok": true, "device": {...}}.  Any failure raises and exits
non-zero before that line is printed.

Bounds (`bound_ms`): the larger of the bytes the kernel must move (each
input read once, each output written once) over 3.35 TB/s and its FP32
operations over 67 TFLOP/s (the H100 SXM's published peaks at 700 W).  The
clip's operations are counted on this run's pairs (`clip_flops`).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SPHERE_TRIS = 2_000_000
SPHERE_RES = 1024
# The JAX package's count for the same table on the CPU, run op by op (no
# multiply-add contraction, like the port).  Grazing pairs at voxel faces
# fall either side of the clip's epsilon tests under other roundings: a TPU
# run recorded 4,936,253, and the jitted XLA CPU clip, which contracts
# multiply-adds into FMAs, gives 4,936,300.  The textured table is the same
# geometry, and K4's area is K1's, so it gives the same voxel set.
SPHERE_VOXELS = 4_936_255
# Phase 12's textured sphere through `Instance.set_input_soup`: the host
# transform and subdivision build another table, whose VL32 output the JAX
# package op by op and the port give byte for byte alike on the CPU
# (scripts/instance_sphere_count.py): its count and the bytes' sha256.
INSTANCE_SPHERE_VOXELS = 4_936_254
INSTANCE_SPHERE_SHA256 = "d278e83022e97f7375fa04d4ac9ec8322ac8eac08a0f2a45f8716e2501cb7271"
# Phase 17: BASELINE.md config 5 (scripts/scale_proof.py:104-115), 1000
# small spheres at 64^3 MAX through `voxelize_batch`.  Its voxel count and
# the sha256 of the per-mesh outputs (`batch_digest`) are the port's on the
# CPU, and the JAX package's run op by op on the CPU gives the same count
# and digest for the whole batch (scripts/batch_count.py).
BATCH_MESHES = 1000
BATCH_RES = 64
BATCH_VOXELS = 18_162_858
BATCH_SHA256 = "b94329ff2410c1f3078bc20ab567f91035c5ac2002c89296c5826b98dfe16e92"
# Phase 19: the unit cube at r = 32 through the C shim (capi_test.c).
CUBE_32_VOXELS = 5768
# Phases 21-23: the port's CPU runs of the same calls
# (scripts/scale_count_torch.py).  Phase 21: the bench entry's host mode
# (the 2M-triangle sphere as a soup through voxelize_soup, BLEND; the host
# transform and subdivision build another table than device mode's), and
# device mode on bench.py's 10M-triangle table at 1024^3: its voxels and the
# sha256 of its sorted voxel set (`bench.occupancy_sha256`).
HOST_SPHERE_VOXELS = 4_936_254
SPHERE_10M_TRIS = 10_000_000
SPHERE_10M_VOXELS = 4_936_280
SPHERE_10M_SHA256 = "94e2e6b3bd7271be1ad644ee5d1d548c848e25d6ffde83e6efe547736583003c"
# Phase 22: BASELINE config 4, the 10M-triangle sphere as a binary STL through
# `Instance` into VL32 at 2048^3 (MAX): voxels and the file's sha256; an STL
# carries no color, so every voxel is one ARGB.
CONFIG4_VOXELS = 19_755_332
CONFIG4_SHA256 = "e21d7a0278cc1daeca9e50e10d39272dad2c5814b8f2ba8e6025a22606603876"
STL_ARGB = 0xFFFFFFFF
# Phase 23: BASELINE config 6, the 100k-triangle helix as a binary STL through
# `Instance` into VL32 at 8192^3: 274 slabs, planned on the host.
CONFIG6_VOXELS = 9_867_131
CONFIG6_SHA256 = "9b531ad5069398c3e1712e961b85dd8157bbfee26c49e92791ce6f6d8986b621"
BUDGET = 1 << 21
STREAM = 1 << 22
INV = (1 << 31) - 1
TEXTURE_SIDE = 4096
PALETTE = 64

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

KERNELS = {
    "fused_pass": ("obj2voxel_tpu_torch/csrc/fused_pass.cu",
                   "obj2voxel_tpu/ops/pass_fused.py:251"),
    # K1's batched form (the TPU kernel's nbatch > 1)
    "fused_pass_batch": ("obj2voxel_tpu_torch/csrc/fused_pass.cu",
                         "obj2voxel_tpu/ops/pass_fused.py:251"),
    "segment_combine": ("obj2voxel_tpu_torch/csrc/reduce_by_key.cu",
                        "obj2voxel_tpu/ops/combine_pallas.py:126"),
    "pack_exact": ("obj2voxel_tpu_torch/csrc/reduce_by_key.cu",
                   "obj2voxel_tpu/ops/pack_pallas.py:285"),
    # K2 then K3 in one pass: the slab merge's combine
    "combine_pack": ("obj2voxel_tpu_torch/csrc/reduce_by_key.cu",
                     "obj2voxel_tpu/ops/combine.py:135"),
    "clip_pairs": ("obj2voxel_tpu_torch/csrc/clip_pairs.cu",
                   "obj2voxel_tpu/ops/clip_pallas.py:64"),
    "pack_channels": ("obj2voxel_tpu_torch/csrc/pack_channels.cu",
                      "obj2voxel_tpu/ops/pack_pallas.py:377"),
    "merge_runs": ("obj2voxel_tpu_torch/csrc/merge_runs.cu",
                   "obj2voxel_tpu/ops/merge_pallas.py:268"),
}
# the kernels each main path must launch (sharded: BLEND in 2 windows, then
# MAX in 3 under O2V_MERGE_RUNS=1; clip_helper: the public per-pair clip;
# batched: the sphere, the supersampled sphere and the batch under
# O2V_BATCH=8, whose lone remainders still run single K1 passes; bench: the
# bench entry's modes; scale_2048 and scale_8192: configs 4 and 6 through
# Instance)
PATH_KERNELS = {
    "untextured": ("fused_pass", "combine_pack"),
    "textured": ("fused_pass", "combine_pack"),
    "merge_runs": ("fused_pass", "merge_runs", "combine_pack"),
    "supersampled": ("fused_pass", "combine_pack"),
    "batch": ("fused_pass", "combine_pack"),
    "sharded": ("fused_pass", "merge_runs", "combine_pack"),
    "clip_helper": ("clip_pairs",),
    "batched": ("fused_pass", "fused_pass_batch", "combine_pack"),
    "bench": ("fused_pass", "combine_pack"),
    "scale_2048": ("fused_pass", "combine_pack"),
    "scale_8192": ("fused_pass", "combine_pack"),
}
# the kernels a main path must not launch: every merge runs K2 and K3 as
# combine_pack, and every pass clips in K1
PATH_ABSENT = {path: ("segment_combine", "pack_exact") for path in PATH_KERNELS}
for path in ("textured", "batch", "sharded", "batched", "bench", "scale_2048",
             "scale_8192"):
    PATH_ABSENT[path] += ("clip_pairs",)
for path in ("bench", "scale_2048", "scale_8192"):
    PATH_ABSENT[path] += ("merge_runs",)
for path in PATH_KERNELS:
    if "fused_pass_batch" not in PATH_KERNELS[path]:
        PATH_ABSENT[path] += ("fused_pass_batch",)
ALL_PHASES = set(range(1, 24))


def fail(msg):
    raise RuntimeError(msg)


def phase(name, t0, detail):
    print(f"[phase] {name}: PASS ({time.perf_counter() - t0:.2f} s) {detail}",
          flush=True)


def gpu_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def cuda_ms(fn, reps=10):
    """Mean ms per call over `reps` calls after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def in_turns(kernel, library, reps=10):
    """CUDA-event ms of a kernel and of the library call for the same
    function, timed in turns (kernel, library, library, kernel); returns the
    two means and the four times in that order."""
    times = [cuda_ms(fn, reps) for fn in (kernel, library, library, kernel)]
    return (times[0] + times[3]) / 2, (times[1] + times[2]) / 2, times


def bound(stats, name, n_bytes, n_ops):
    """Record the least time the card could take for the work."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    stats[name].update(
        bound_ms=max(by_bytes, by_ops),
        bound_by="bytes" if by_bytes >= by_ops else "operations",
        bytes=int(n_bytes), ops=int(n_ops),
    )


def clip_flops(tri, vox, live, nch):
    """FP32 operations the clip runs on the pairs where `live` (the op model
    of ops/clip.py and csrc/o2v_clip.cuh): 3 plane offsets; per plane one
    subtraction per polygon vertex and 4 + 3 nch per edge crossing the
    plane; per fan triangle of the clipped polygon 23, plus 10 for the UV
    centroid and 2 final divides when nch = 5."""
    from obj2voxel_tpu_torch.constants import EPSILON
    from obj2voxel_tpu_torch.ops.clip import _clip_one_plane

    tri, vox = tri[:, live], vox[:, live]

    def slot(i):
        return torch.cat([tri[3 * i : 3 * i + 3], tri[9 + 2 * i : 11 + 2 * i]])

    s0 = slot(0)
    slots = [s0, slot(1), slot(2), s0]
    count = torch.full((1, tri.shape[1]), 3, dtype=torch.int32, device=tri.device)
    ops = 3 * tri.shape[1]
    for hi in (False, True):
        for axis in range(3):
            plane = vox[axis : axis + 1] + (1.0 if hi else 0.0)
            vals = [s[axis] for s in slots]
            valid = [count > i for i in range(len(slots))]
            all_lo = torch.ones_like(valid[0])
            for i in range(len(slots) - 1):
                all_lo &= (vals[i] < plane) | ~valid[i]
            inside = 0
            for i in range(len(slots) - 1):
                gap = plane - vals[i]
                ins = (all_lo | ((vals[i] < plane) & (gap >= EPSILON))) if hi else (
                    (gap < EPSILON) & ~all_lo)
                inside = inside + (ins & valid[i]).to(torch.int64)
            ops += int(count.sum())
            slots, new_count = _clip_one_plane(slots, count, axis, plane, keep_hi=not hi)
            ops += int((new_count.to(torch.int64) - inside).sum()) * (4 + 3 * nch)
            count = new_count
    pieces = int(torch.clamp(count.to(torch.int64) - 2, min=0).sum())
    ops += pieces * (23 + (10 if nch == 5 else 0))
    if nch == 5:
        ops += 2 * tri.shape[1]
    return ops


def sphere_table(n_tris, res, textured=False):
    """bench.py's device-resident table (`obj2voxel_tpu_torch.bench.sphere_table`):
    the sphere in voxel space, padded to a power of two, plus its host
    AABBs; textured=True gives its rows spherical UVs and texture 0."""
    from obj2voxel_tpu_torch.bench import sphere_table as table

    table_np, aabb, _ = table(n_tris, res, textured)
    return table_np, aabb


def palette_texels(seed=12):
    """(TEXTURE_SIDE^2 uint32 texels drawn from PALETTE opaque colors, the
    palette uint32)."""
    rng = np.random.default_rng(seed)
    palette = (0xFF000000 | rng.integers(0, 1 << 24, PALETTE)).astype(np.uint32)
    return palette[rng.integers(0, PALETTE, (TEXTURE_SIDE, TEXTURE_SIDE))], palette


def palette_pool(seed=12):
    """One REPEAT texture of `palette_texels`; returns (TexturePool, palette
    uint32)."""
    from obj2voxel_tpu_torch import TexturePool
    from obj2voxel_tpu_torch.constants import UV_WRAP

    texels, palette = palette_texels(seed)
    pool = TexturePool()
    pool.add(texels, UV_WRAP)
    return pool, palette


def sphere_pass(table, aabb, pass_index):
    """The plan-ordered sphere table and the descriptor of one of its
    2^21-slot passes at expand 8 (the shape of the main path's passes)."""
    from obj2voxel_tpu_torch.ops.plan_device import gather_ordered, plan_mesh_device

    order, segs = plan_mesh_device(table, aabb[0].shape[0], SPHERE_RES,
                                   SPHERE_RES, 4 * BUDGET, group=8)
    ordered = gather_ordered(table, order, segs[-1].r1, 8)
    seg = segs[pass_index(len(segs))]
    r0 = min(s.r0 for s in segs if (s.z_lo, s.z_hi) == (seg.z_lo, seg.z_hi))
    return ordered, r0, seg.z_lo, seg.z_hi


def compare_pass(got, want, what):
    """K1 outputs: keys, count and order equal; weights to rtol 1e-6."""
    n = int(want[5].item())
    if int(got[5].item()) != n:
        fail(f"{what}: count {int(got[5].item())} != {n}")
    if not torch.equal(got[0], want[0]):
        fail(f"{what}: keys differ")
    err = 0.0
    for g, w in zip(got[1:5], want[1:5]):
        if not torch.allclose(g, w, rtol=1e-6, atol=0.0):
            fail(f"{what}: channels differ beyond rtol 1e-6")
        err = max(err, float((g - w).abs().max()))
    return n, err


def phase_k1(stats):
    from obj2voxel_tpu_torch.ops.pass_fused import fused_pass, fused_pass_ref

    t0 = time.perf_counter()
    table_np, aabb = sphere_table(SPHERE_TRIS, SPHERE_RES)
    ordered, r0, z_lo, z_hi = sphere_pass(torch.from_numpy(table_np).cuda(), aabb,
                                          lambda n: n // 2)
    details, err = [], 0.0
    for expand in (1, 8, 64, BUDGET):
        n_rows = min(BUDGET // expand, ordered.shape[0] - r0)
        args = (ordered, r0, n_rows, 0, z_lo, z_hi, SPHERE_RES)
        kw = dict(expand=expand, budget=BUDGET, wide_local=False)
        n, e = compare_pass(fused_pass(*args, **kw), fused_pass_ref(*args, **kw),
                            f"K1 expand={expand}")
        details.append(f"e{expand}:{n}")
        err = max(err, e)
        if expand == 8:
            stats["fused_pass"].update(
                ms=cuda_ms(lambda: fused_pass(*args, **kw)),
                plain_ms=cuda_ms(lambda: fused_pass_ref(*args, **kw), reps=3),
                library_ms=None,
            )
            from obj2voxel_tpu_torch.ops.clip_pallas import pass_pairs

            tri, vox, _, _, valid = pass_pairs(ordered.T.contiguous(), *args[1:], **kw)
            # the 12 columns read of each row (xyz 0:9, rgb 17:20), 20 B per
            # live pair written and the count; the clip, the AABB and rank
            # decode (~25) and the premultiply (3) per slot in its AABB
            bound(stats, "fused_pass", n_rows * 48 + n * 20 + 4,
                  clip_flops(tri, vox, valid, 3) + 28 * int(valid.sum()))
            del tri, vox, valid
            # the input-area variant on the same pass
            n, e = compare_pass(fused_pass(*args, ref_weights=True, **kw),
                                fused_pass_ref(*args, ref_weights=True, **kw),
                                "K1 ref_weights expand=8")
            details.append(f"ref_weights:{n}")
            err = max(err, e)
    # one giant slanted triangle at 2048^3: AABB 2048 x 2048 x 4 = 2^24 slots
    giant = np.zeros((1, 24), np.float32)
    giant[0, 0:9] = [0.5, 0.5, 0.5, 2047.5, 0.5, 3.5, 0.5, 2047.5, 3.5]
    giant[0, 17:20] = [0.2, 0.4, 0.8]
    giant_t = torch.from_numpy(giant).cuda()
    for local_base in (1 << 23, (1 << 23) + BUDGET):
        args = (giant_t, 0, 1, local_base, 0, 510, 2048)
        kw = dict(expand=BUDGET, budget=BUDGET, wide_local=True)
        n, e = compare_pass(fused_pass(*args, **kw), fused_pass_ref(*args, **kw),
                            f"K1 wide_local base={local_base}")
        if n == 0:
            fail("K1 wide_local pass produced no live pair")
        details.append(f"wide@{local_base}:{n}")
        err = max(err, e)
    stats["fused_pass"]["max_abs_err"] = err
    details += k1_textured(stats)
    phase("2 K1 fused_pass vs plain", t0, " ".join(details))


def compare_exact(got, want, what):
    """K1 textured outputs: keys, count, order, rows and w, u, v equal to the
    plain version's bit for bit (both round every float32 operation to
    nearest, in the same order); returns the count."""
    n = int(want[5].item())
    if int(got[5].item()) != n:
        fail(f"{what}: count {int(got[5].item())} != {n}")
    for g, w, name in zip(got, want, ("keys", "w", "u", "v", "rows")):
        if g.dtype != w.dtype or not torch.equal(g.view(torch.int32),
                                                 w.view(torch.int32)):
            fail(f"{what}: {name} differ from the plain version")
    return n


def grazing_table(n):
    """grazing_pairs' triangles as (n, 24) table rows: at expand 1 each
    row's one slot is the voxel at its AABB's low corner."""
    tri, _ = grazing_pairs(n)
    table = torch.zeros((n, 24), dtype=torch.float32, device=tri.device)
    table[:, 0:16] = tri.T
    return table.contiguous()


def k1_textured(stats):
    """K1's textured variant against its plain version, with and without
    ref_weights: the sphere pass of phase 2 on the textured table, and
    grazing_pairs as table rows at expand 1 and 8; then its timing."""
    from obj2voxel_tpu_torch.ops.clip_pallas import pass_pairs
    from obj2voxel_tpu_torch.ops.pass_fused import fused_pass, fused_pass_ref

    table_np, aabb = sphere_table(SPHERE_TRIS, SPHERE_RES, textured=True)
    ordered, r0, z_lo, z_hi = sphere_pass(torch.from_numpy(table_np).cuda(), aabb,
                                          lambda n: n // 2)
    n_rows = min(BUDGET // 8, ordered.shape[0] - r0)
    sphere = ((ordered, r0, n_rows, 0, z_lo, z_hi, SPHERE_RES),
              dict(expand=8, budget=BUDGET, wide_local=False, textured=True))
    graze = grazing_table(4096)
    cases = [("sphere pass", *sphere)] + [
        (f"grazing rows expand {e}", (graze, 0, 4096, 0, 0, 16, 16),
         dict(expand=e, budget=4096 * e, wide_local=False, textured=True))
        for e in (1, 8)]
    details = []
    for what, args, kw in cases:
        for ref in (False, True):
            n = compare_exact(fused_pass(*args, ref_weights=ref, **kw),
                              fused_pass_ref(*args, ref_weights=ref, **kw),
                              f"K1 textured {what} ref_weights={ref}")
            details.append(f"textured {what}{' ref_weights' if ref else ''}:{n}")
    # the boundary case: a triangle in the plane x = 6 lies in voxel x = 6
    edge = fused_pass(graze, 0, 2, 0, 0, 16, 16, expand=1, budget=256,
                      textured=True)
    if int(edge[5].item()) != 2 or int(edge[0][0]) != (5 * 16 + 5) * 16 + 6:
        fail("K1 textured: a plane on a voxel face must belong to the hi voxel")
    args, kw = sphere
    t = stats["fused_pass_textured"]
    t.update(ms=cuda_ms(lambda: fused_pass(*args, **kw)),
             plain_ms=cuda_ms(lambda: fused_pass_ref(*args, **kw), reps=3),
             library_ms=None, max_abs_err=0.0)
    n = int(fused_pass(*args, **kw)[5].item())
    tri, vox, _, _, valid = pass_pairs(ordered.T.contiguous(), *args[1:],
                                       expand=8, budget=BUDGET, wide_local=False)
    # the 15 columns read of each row (xyz 0:9, uv 9:15), 20 B per live pair
    # written (key, w, u, v, row) and the count; the clip with UVs, the
    # AABB and rank decode (~25) per slot in its AABB
    bound(stats, "fused_pass_textured", n_rows * 60 + n * 20 + 4,
          clip_flops(tri, vox, valid, 5) + 25 * int(valid.sum()))
    return details


def k2_streams(rng):
    """Key-sorted streams: runs of 1..5000 crossing tile edges (with weight
    ties), one run spanning everything, all INVALID."""
    lengths = rng.integers(1, 5001, size=STREAM // 1000)
    lengths[::7] = rng.integers(1, 4, size=lengths[::7].shape)
    keys = np.repeat(np.arange(lengths.size, dtype=np.int64) * 3, lengths)[:STREAM]
    keys[-STREAM // 10:] = INV
    mixed = keys.astype(np.int32)
    return {
        "runs": mixed,
        "one_run": np.full(STREAM, 12345, np.int32),
        "all_invalid": np.full(STREAM, INV, np.int32),
    }


def tie_chans(rng, n):
    """(w, wr, wg, wb) on the card, with quantized weights that make MAX
    ties common."""
    w = torch.from_numpy(rng.integers(1, 5, n).astype(np.float32) / 4).cuda()
    return (w, *(torch.from_numpy(rng.random(n, dtype=np.float32)).cuda() * w
                 for _ in range(3)))


def k2_inputs(seed=2):
    """Phase 3's inputs on the card: (name, keys, (w, wr, wg, wb)) for each
    of `k2_streams`."""
    rng = np.random.default_rng(seed)
    for name, keys_np in k2_streams(rng).items():
        yield name, torch.from_numpy(keys_np).cuda(), tie_chans(rng, keys_np.size)


def phase_k2(stats):
    from obj2voxel_tpu_torch.ops.combine_pallas import (
        segment_combine, segment_combine_ref,
    )

    t0 = time.perf_counter()
    err, details = 0.0, []
    for name, keys, (w, *rgb) in k2_inputs():
        for blend in (False, True):
            got = segment_combine(keys, w, *rgb, blend)
            want = segment_combine_ref(keys, w, *rgb, blend)
            if not torch.equal(got[0], want[0]):
                fail(f"K2 {name} blend={blend}: tail keys differ")
            for g, x in zip(got[1:], want[1:]):
                if blend:
                    if not torch.allclose(g, x, rtol=1e-5, atol=1e-6):
                        fail(f"K2 {name} blend: sums beyond rtol 1e-5")
                    err = max(err, float((g - x).abs().max()))
                elif not torch.equal(g, x):
                    fail(f"K2 {name} max: values differ")
            details.append(f"{name}/{'blend' if blend else 'max'}:"
                           f"{int((got[0] != INV).sum())}")
            if name == "runs" and blend:
                live = keys != INV
                data = torch.stack([w, *rgb], dim=1)[live]
                lengths = torch.unique_consecutive(keys[live], return_counts=True)[1]
                stats["segment_combine"].update(
                    ms=cuda_ms(lambda: segment_combine(keys, w, *rgb, True)),
                    plain_ms=cuda_ms(lambda: segment_combine_ref(keys, w, *rgb, True)),
                    library_ms=cuda_ms(lambda: torch.segment_reduce(
                        data, "sum", lengths=lengths)),
                )
                # 20 B per row in and out; 4 additions per live row
                bound(stats, "segment_combine", STREAM * 40, 4 * int(live.sum()))
    stats["segment_combine"]["max_abs_err"] = err
    phase("3 K2 segment_combine vs plain", t0, " ".join(details))


def pack_phase(stats, name, kernel, plain, label):
    """K3 and K5: the kernel against its plain version at STREAM rows with
    live fractions 0, 1/4 and 1, timed at 1/4 in turns with boolean-mask
    indexing."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    details = []
    for frac in (0.0, 0.25, 1.0):
        keys_np = rng.integers(0, 1 << 30, STREAM).astype(np.int32)
        keys_np[rng.random(STREAM) >= frac] = INV
        keys = torch.from_numpy(keys_np).cuda()
        vals = tuple(torch.from_numpy(rng.random(STREAM, dtype=np.float32)).cuda()
                     for _ in range(4))
        gk, gv, gc = kernel(keys, vals)
        wk, wv, wc = plain(keys, vals)
        if not (torch.equal(gc, wc) and torch.equal(gk, wk)
                and all(torch.equal(a, b) for a, b in zip(gv, wv))):
            fail(f"{label} live fraction {frac}: output differs")
        details.append(f"{frac}:{int(gc.item())}")
        if frac == 0.25:
            rows = torch.stack([keys, *(v.view(torch.int32) for v in vals)])

            def library():
                return rows[:, rows[0] != INV]

            ms, lib_ms, times = in_turns(lambda: kernel(keys, vals), library)
            details.append(f"in turns (kernel, library, library, kernel) "
                           f"{[round(t, 4) for t in times]} ms: kernel {ms:.4f} "
                           f"ms, rows[:, mask] {lib_ms:.4f} ms, kernel/library "
                           f"{ms / lib_ms:.3f}")
            stats[name].update(ms=ms, library_ms=lib_ms,
                               plain_ms=cuda_ms(lambda: plain(keys, vals)))
            # every row read, and every row written: the live rows (K5: up
            # to the padded count), the (INVALID, 0) fill past the count,
            # and the count
            bound(stats, name, STREAM * 40 + 4, 0)
    stats[name]["max_abs_err"] = 0.0
    phase(label, t0, " ".join(details))


def phase_k3(stats):
    from obj2voxel_tpu_torch.ops.pack_pallas import pack_exact, pack_exact_ref

    pack_phase(stats, "pack_exact", pack_exact, pack_exact_ref,
               "4 K3 pack_exact vs plain")


def rbk_streams(rng):
    """The cases a chained reduce-by-key gets wrong, as (name, sorted keys):
    runs ending exactly at tile edges (and one row either side), one run
    crossing many tiles, one tile alone, every tail in the last tile (a run
    over all the tiles before it), and 2^24 rows (4096 tiles, many waves of
    look-back)."""
    from obj2voxel_tpu_torch.ops.reduce_by_key import RBK_TILE as T

    def runs(lengths, n):
        keys = np.repeat(np.arange(len(lengths), dtype=np.int64) * 3, lengths)[:n]
        return np.pad(keys, (0, n - keys.size), constant_values=INV).astype(np.int32)

    short = rng.integers(1, 50, STREAM)
    pattern = [T, T // 2, T // 2 - 1, 1, 1, T - 1, 3 * T + 1, T - 1]
    last = np.full(STREAM, 5, np.int32)
    last[-1000:] = np.sort(rng.integers(6, 100, 1000))
    big = rng.integers(1, 64, 1 << 24)
    big_keys = runs(big, 1 << 24)
    big_keys[-(1 << 20):] = INV
    return {
        "runs at tile edges": runs(np.tile(pattern, STREAM // T), STREAM),
        "a run over 300 tiles": runs(np.concatenate(
            [short[:20_000], [300 * T + 7], short[20_000:]]), STREAM),
        "one tile": np.sort(rng.integers(0, 50, T)).astype(np.int32),
        "tails only in the last tile": last,
        "2^24 rows": big_keys,
    }


def phase_rbk(stats):
    """combine_pack (K2 then K3 in one pass) against its plain version on
    phase 3's streams and on the chained scan's own cases, BLEND and MAX,
    each called twice on one input; then timed on the sphere's real merge
    input beside the plain chain and the K2 -> K3 instances."""
    from obj2voxel_tpu_torch.ops.combine import sort_channels
    from obj2voxel_tpu_torch.ops.combine_pallas import (
        combine_pack, combine_pack_ref, segment_combine,
    )
    from obj2voxel_tpu_torch.ops.pack_pallas import pack_exact

    t0 = time.perf_counter()
    rng = np.random.default_rng(16)
    cases = [(name, keys, chans) for name, keys, chans in k2_inputs()]
    cases += [(name, torch.from_numpy(k).cuda(), tie_chans(rng, k.size))
              for name, k in rbk_streams(rng).items()]
    err, details = 0.0, []
    for name, keys, chans in cases:
        for blend in (False, True):
            wk, wv, wc = combine_pack_ref(keys, chans, blend)
            for call in ("first", "second"):
                # a second call on the same input must not read the first's flags
                gk, gv, gc = combine_pack(keys, chans, blend)
                what = f"combine_pack {name} blend={blend}, {call} call"
                if not (torch.equal(gc, wc) and torch.equal(gk, wk)):
                    fail(f"{what}: keys or count differ from the plain version")
                for g, x in zip(gv, wv):
                    if blend:
                        if not torch.allclose(g, x, rtol=1e-5, atol=1e-6):
                            fail(f"{what}: sums beyond rtol 1e-5")
                        err = max(err, float((g - x).abs().max()))
                    elif not torch.equal(g, x):
                        fail(f"{what}: values differ")
        details.append(f"{name}: {keys.numel()} rows, count {int(wc.item())}")
    del cases

    table_np, aabb = sphere_table(SPHERE_TRIS, SPHERE_RES)
    keys, chans = sort_channels(*sphere_slab_runs(torch.from_numpy(table_np).cuda(),
                                                  aabb)[:2])
    wk, wv, wc = combine_pack_ref(keys, chans, True)
    gk, gv, gc = combine_pack(keys, chans, True)
    if not (torch.equal(gc, wc) and torch.equal(gk, wk) and all(
            torch.allclose(g, x, rtol=1e-5, atol=1e-6) for g, x in zip(gv, wv))):
        fail("combine_pack sphere slab merge: differs from the plain version")
    err = max([err] + [float((g - x).abs().max()) for g, x in zip(gv, wv)])
    live = keys != INV
    data = torch.stack(chans, dim=1)[live]
    lengths = torch.unique_consecutive(keys[live], return_counts=True)[1]

    def chain():
        tk, *tv = segment_combine(keys, *chans, True)
        return pack_exact(tk, tuple(tv))

    ms, lib_ms, turns = in_turns(
        lambda: combine_pack(keys, chans, True),
        lambda: torch.segment_reduce(data, "sum", lengths=lengths))
    plain_ms = cuda_ms(lambda: combine_pack_ref(keys, chans, True))
    chain_ms = cuda_ms(chain)
    stats["combine_pack"].update(ms=ms, library_ms=lib_ms, plain_ms=plain_ms,
                                 max_abs_err=err)
    # 20 B a row read; 20 B a row written (the unique rows, then the
    # (INVALID, 0) fill) and the count; 4 additions a live row
    bound(stats, "combine_pack", keys.numel() * 40 + 4, 4 * int(live.sum()))
    details.append(
        f"sphere slab merge {keys.numel()} rows -> {int(gc.item())} voxels, in "
        f"turns (combine_pack, segment_reduce, segment_reduce, combine_pack) "
        f"{[round(t, 4) for t in turns]} ms: combine_pack {ms:.4f} ms, "
        f"segment_reduce {lib_ms:.4f} ms; K2 -> K3 instances {chain_ms:.4f} ms; "
        f"plain chain {plain_ms:.4f} ms; bound "
        f"{stats['combine_pack']['bound_ms']:.4f} ms")
    phase("16 combine_pack vs plain", t0, "; ".join(details))


def k5_streams(rng):
    """The cases a chained scan gets wrong, as (name, keys): blocks whose
    live count is exactly a multiple of 128, a block with one live row,
    empty blocks, all live rows in the last block, one block alone, and
    2^24 rows (2048 blocks, many waves of look-back)."""
    from obj2voxel_tpu_torch.ops.pack_pallas import PACK_BLOCK

    def quarter(n):
        keys = rng.integers(0, 1 << 30, n).astype(np.int32)
        keys[rng.random(n) >= 0.25] = INV
        return keys

    mixed = quarter(STREAM)
    for blk, live in ((1, 384), (2, 1), (3, 0), (4, PACK_BLOCK), (5, 128)):
        rows = mixed[blk * PACK_BLOCK:(blk + 1) * PACK_BLOCK]
        rows[:] = INV
        rows[rng.choice(PACK_BLOCK, live, replace=False)] = rng.integers(0, 1 << 30, live)
    last = np.full(STREAM, INV, np.int32)
    last[-PACK_BLOCK:] = quarter(PACK_BLOCK)
    return {"128k/one/empty blocks": mixed, "last block only": last,
            "one block": quarter(PACK_BLOCK), "2^24 rows": quarter(1 << 24)}


def phase_k5(stats):
    """K5 against its plain version on the generic streams (timed as K3 is)
    and on the chained scan's own cases, each called twice on one input."""
    from obj2voxel_tpu_torch.ops.pack_pallas import pack_channels, pack_channels_ref

    pack_phase(stats, "pack_channels", pack_channels, pack_channels_ref,
               "10 K5 pack_channels vs plain")
    t0 = time.perf_counter()
    rng = np.random.default_rng(10)
    details = []
    for name, keys_np in k5_streams(rng).items():
        keys = torch.from_numpy(keys_np).cuda()
        vals = tuple(torch.from_numpy(rng.random(keys.numel(), dtype=np.float32)).cuda()
                     for _ in range(4))
        want = pack_channels_ref(keys, vals)
        for call in ("first", "second"):
            # a second call on the same input must not read the first's flags
            gk, gv, gc = pack_channels(keys, vals)
            if not (torch.equal(gc, want[2]) and torch.equal(gk, want[0])
                    and all(torch.equal(a, b) for a, b in zip(gv, want[1]))):
                fail(f"K5 {name}, {call} call: output differs from the plain version")
        details.append(f"{name}: {keys.numel()} rows, count {int(gc.item())}")
    phase("10 K5 pack_channels chained-scan cases, each called twice", t0,
          "; ".join(details))


def sphere_slab_runs(table, aabb):
    """K6's input on the merge-runs route: the live outputs of the passes of
    the sphere's slab with the most passes, each stable-sorted by key, laid
    end to end; returns (keys, chans, run offsets)."""
    from obj2voxel_tpu_torch.engine import _schedule_passes
    from obj2voxel_tpu_torch.ops.combine import sort_channels
    from obj2voxel_tpu_torch.ops.merge_pallas import plan_runs
    from obj2voxel_tpu_torch.ops.pass_fused import fused_pass
    from obj2voxel_tpu_torch.ops.plan_device import gather_ordered, plan_mesh_device

    order, segs = plan_mesh_device(table, aabb[0].shape[0], SPHERE_RES,
                                   SPHERE_RES, 4 * BUDGET, group=8)
    ordered = gather_ordered(table, order, segs[-1].r1, 8)
    slabs = {}
    for seg in segs:
        slabs.setdefault((seg.z_lo, seg.z_hi), []).append(seg)
    (z_lo, z_hi), passes = max(
        ((zz, _schedule_passes(ss, BUDGET)) for zz, ss in slabs.items()),
        key=lambda item: len(item[1]))
    runs = []
    for expand, budget, r0, n_rows, local_base, wide in passes:
        out = fused_pass(ordered, r0, n_rows, local_base, z_lo, z_hi, SPHERE_RES,
                         expand=expand, budget=budget, wide_local=wide)
        c = int(out[5].item())
        runs.append(sort_channels(out[0][:c], tuple(x[:c] for x in out[1:5])))
    keys = torch.cat([r[0] for r in runs])
    chans = tuple(torch.cat([r[1][j] for r in runs]) for j in range(4))
    return keys, chans, plan_runs([r[0].shape[0] for r in runs])[0]


def random_runs(rng, counts, key_hi, key_lo=0, edges=()):
    """Key-sorted runs of `counts` rows, keys in [key_lo, key_hi) and, where
    a run holds 8 rows or more, each of `edges` once, on the card."""

    def run(c):
        keys = rng.integers(key_lo, key_hi, c)
        if c >= 8:
            keys[:len(edges)] = edges
        return np.sort(keys)

    keys = np.concatenate([run(c) for c in counts])
    chans = tuple(torch.from_numpy(rng.random(keys.size, dtype=np.float32)).cuda()
                  for _ in range(4))
    offsets = np.concatenate([[0], np.cumsum(counts)]).tolist()
    return torch.from_numpy(keys.astype(np.int32)).cuda(), chans, offsets


def phase_k6(stats):
    from obj2voxel_tpu_torch.ops.merge_pallas import (
        MERGE_TILE, merge_runs, merge_runs_ref,
    )

    t0 = time.perf_counter()

    def check(keys, chans, offsets, what):
        """K6 equal to its plain version and to the stable sort, bit for
        bit."""
        gk, gc = merge_runs(keys, chans, offsets)
        wk, wc = merge_runs_ref(keys, chans, offsets)
        if not (torch.equal(gk, wk) and all(torch.equal(a, b) for a, b in zip(gc, wc))):
            fail(f"K6 {what}: differs from the plain version")
        sk, idx = torch.sort(keys, stable=True)
        if not (torch.equal(gk, sk) and all(torch.equal(a, c[idx])
                                            for a, c in zip(gc, chans))):
            fail(f"K6 {what}: differs from the stable sort")
        return f"{what}: {len(offsets) - 1} runs, {keys.numel()} rows"

    table_np, aabb = sphere_table(SPHERE_TRIS, SPHERE_RES)
    keys, chans, offsets = sphere_slab_runs(torch.from_numpy(table_np).cuda(), aabb)
    details = [check(keys, chans, offsets, "sphere slab")]
    rng = np.random.default_rng(13)
    for s in (2, 3, 11, 32):
        counts = rng.integers(0, 400_000, s)
        counts[s // 2] = 0  # an empty run
        # few distinct keys: stability is the whole test
        details.append(check(*random_runs(rng, counts, 64), f"S={s} dup"))
        details.append(check(*random_runs(rng, counts, 1 << 30), f"S={s}"))
    # the cases a tiled merge path gets wrong
    tile = MERGE_TILE
    most_empty = np.zeros(32, np.int64)
    most_empty[[3, 17, 30, 31]] = (300_001, 1, 2 * tile, 250_000)
    cases = (
        # every tie crosses tile boundaries
        ("S=32 one key", rng.integers(1, 200_000, 32), dict(key_lo=77, key_hi=78)),
        ("S=32 runs of one row", np.ones(32, np.int64), dict(key_hi=8)),
        ("S=17 one-row runs among long ones",
         np.where(np.arange(17) % 2, 1, 150_001), dict(key_hi=1000)),
        ("run lengths off the tile",
         np.array([tile - 1, tile + 1, 7 * tile, 5 * tile - 1, 1, 3 * tile + 2]),
         dict(key_hi=300)),
        ("S=32 most runs empty", most_empty, dict(key_hi=5000)),
        ("one run longer than the rest", np.array([3_000_000, 50_000, 200_000, 7, 1000]),
         dict(key_hi=1 << 30)),
        ("whole int32 range, INVALID included", rng.integers(0, 300_000, 9),
         dict(key_lo=-(1 << 31), key_hi=1 << 31, edges=(-(1 << 31), INV, INV))),
    )
    for what, counts, kw in cases:
        details.append(check(*random_runs(rng, counts, **kw), what))

    def library():
        sk, idx = torch.sort(keys, stable=True)
        return sk, tuple(c[idx] for c in chans)

    ms, lib_ms, turns = in_turns(lambda: merge_runs(keys, chans, offsets), library)
    stats["merge_runs"].update(
        ms=ms, library_ms=lib_ms, max_abs_err=0.0,
        plain_ms=cuda_ms(lambda: merge_runs_ref(keys, chans, offsets)),
    )
    details.append(f"sphere slab in turns (K6, library, library, K6) "
                   f"{[round(t, 4) for t in turns]} ms: K6 {ms:.4f} ms, "
                   f"torch.sort(stable) + 4 gathers {lib_ms:.4f} ms, K6/library "
                   f"{ms / lib_ms:.3f}")
    # each row (key + 4 channels) read once and written once
    bound(stats, "merge_runs", keys.numel() * 40, 0)
    phase("13 K6 merge_runs vs plain", t0, "; ".join(details))


def grazing_pairs(n, seed=9):
    """Pairs whose triangle lies in, or within 1e-5 of, a voxel face, plus
    the boundary case of a plane on a face (it belongs to the hi voxel)."""
    rng = np.random.default_rng(seed)
    vox = rng.integers(0, 8, size=(n, 3)).astype(np.float32)
    verts = vox[:, None, :] + rng.uniform(0, 1, size=(n, 3, 3))
    axis = rng.integers(0, 3, size=n)
    offset = rng.choice([0.0, 1.0, 1e-5, -1e-5, 1 + 1e-5, 1 - 1e-5, 2 ** -16], size=n)
    verts[np.arange(n), :, axis] = (vox[np.arange(n), axis] + offset)[:, None]
    verts[:2] = [[6.0, 5.2, 5.2], [6.0, 5.8, 5.2], [6.0, 5.2, 5.8]]
    vox[0], vox[1] = (6, 5, 5), (5, 5, 5)
    tri = np.zeros((16, n), np.float32)
    tri[0:9] = verts.reshape(n, 9).T
    tri[9:15] = rng.uniform(-2, 3, size=(n, 6)).T
    vox4 = np.zeros((4, n), np.float32)
    vox4[:3] = vox.T
    return torch.from_numpy(tri).cuda(), torch.from_numpy(vox4).cuda()


def compare_clip(got, want, what):
    """K4 outputs: w, u and v equal to the plain version's bit for bit (both
    round every float32 operation to nearest, in the same order); returns
    (occupied pairs, max abs error)."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        fail(f"{what}: differs from the plain version (max abs error {err})")
    return int((want[0] > 0).sum()), err


def phase_k4(stats):
    from obj2voxel_tpu_torch.ops.clip_pallas import (
        clip_pairs, clip_pairs_ref, pass_pairs,
    )

    t0 = time.perf_counter()
    table_np, aabb = sphere_table(SPHERE_TRIS, SPHERE_RES, textured=True)
    ordered, r0, z_lo, z_hi = sphere_pass(torch.from_numpy(table_np).cuda(), aabb,
                                          lambda n: n // 2)
    n_rows = min(BUDGET // 8, ordered.shape[0] - r0)
    tri, vox, _, _, valid = pass_pairs(ordered.T.contiguous(), r0, n_rows, 0,
                                       z_lo, z_hi, SPHERE_RES, expand=8,
                                       budget=BUDGET, wide_local=False)
    occ, err = compare_clip(clip_pairs(tri, vox), clip_pairs_ref(tri, vox),
                            "K4 sphere pass")
    gtri, gvox = grazing_pairs(4096)
    gocc, gerr = compare_clip(clip_pairs(gtri, gvox), clip_pairs_ref(gtri, gvox),
                              "K4 grazing pairs")
    edge = clip_pairs(gtri[:, :2].contiguous(), gvox[:, :2].contiguous())
    if not (float(edge[0, 0]) > 0 and float(edge[0, 1]) == 0.0):
        fail("K4: a plane on a voxel face must belong to the hi voxel")
    stats["clip_pairs"].update(
        ms=cuda_ms(lambda: clip_pairs(tri, vox)),
        plain_ms=cuda_ms(lambda: clip_pairs_ref(tri, vox), reps=3),
        library_ms=None, max_abs_err=max(err, gerr),
    )
    # 72 B read (tri rows 0:15, vox rows 0:3) and 16 B written per pair;
    # the clip's operations on all pairs (the kernel clips every slot of
    # the budget)
    everything = torch.ones_like(valid)
    bound(stats, "clip_pairs", BUDGET * 88, clip_flops(tri, vox, everything, 5))
    phase("9 K4 clip_pairs vs plain", t0,
          f"sphere pass {BUDGET} pairs, {occ} occupied; grazing 4096 pairs, "
          f"{gocc} occupied; max abs err {max(err, gerr):.3g}")
    return clip_helper(tri, vox)


def clip_helper(tri, vox):
    """The public per-pair clip `clip_triangles_to_voxels_pallas` on the
    sphere pass's pairs as (P, 3, 3) / (P, 3, 2) / (P, 3), with the launch
    counts reset just before it and read just after; held bit for bit
    against its plain version, ops/clip.clip_triangles_to_voxels."""
    import obj2voxel_tpu_torch as pt
    from obj2voxel_tpu_torch.ops.clip import clip_triangles_to_voxels
    from obj2voxel_tpu_torch.ops.clip_pallas import clip_triangles_to_voxels_pallas

    t0 = time.perf_counter()
    n = tri.shape[1]
    verts = tri[0:9].T.reshape(n, 3, 3).contiguous()
    uvs = tri[9:15].T.reshape(n, 3, 2).contiguous()
    pos = vox[0:3].T.to(torch.int32).contiguous()
    pt.reset_launches()
    w, uv = clip_triangles_to_voxels_pallas(verts, uvs, pos)
    torch.cuda.synchronize()
    launches = dict(pt.LAUNCHES)
    check_path("clip_helper", launches)
    want_w, want_uv = clip_triangles_to_voxels(verts, uvs, pos)
    if not (torch.equal(w, want_w) and torch.equal(uv, want_uv)):
        fail("clip_triangles_to_voxels_pallas differs from its plain version")
    phase("9 K4 through clip_triangles_to_voxels_pallas vs plain", t0,
          f"{n} pairs, {int((w > 0).sum())} occupied, bit for bit; launches "
          f"{launches['clip_pairs']}")
    return launches


def voxel_dict(gen):
    out = {}
    for xyz, argb in gen:
        for p, c in zip(xyz.tolist(), argb.tolist()):
            out[tuple(p)] = c
    return out


def compare_voxels(gpu, cpu, blend, what):
    if set(gpu) != set(cpu):
        fail(f"{what}: voxel sets differ ({len(gpu)} vs {len(cpu)})")
    a = np.array([gpu[k] for k in cpu], np.uint32).view(np.uint8).astype(np.int16)
    b = np.array(list(cpu.values()), np.uint32).view(np.uint8).astype(np.int16)
    lsb = int(np.abs(a - b).max()) if a.size else 0
    if lsb > (1 if blend else 0):
        fail(f"{what}: colors differ by {lsb} LSB")
    return f"{len(gpu)} voxels, {lsb} LSB"


def random_soup(n, textured, seed):
    """n seeded triangles ~5 voxels wide at 256^3; textured: 70% sample one
    of four textures (CLAMP and REPEAT, odd sizes, UVs in [-2, 3])."""
    from obj2voxel_tpu_torch import TexturePool, TriangleSoup
    from obj2voxel_tpu_torch.constants import (
        TRI_TEXTURED, TRI_UNTEXTURED, UV_CLAMP, UV_WRAP,
    )

    rng = np.random.default_rng(seed)
    centers = rng.random((n, 1, 3), dtype=np.float32)
    verts = (centers + rng.uniform(-0.01, 0.01, (n, 3, 3))).astype(np.float32)
    types = np.full(n, TRI_UNTEXTURED, np.int32)
    tex = np.full(n, -1, np.int32)
    pool = TexturePool()
    if textured:
        sel = rng.random(n) < 0.7
        types[sel] = TRI_TEXTURED
        tex[sel] = rng.integers(0, 4, int(sel.sum()))
        for i, (h, w) in enumerate([(3, 5), (64, 17), (1, 9), (129, 255)]):
            img = (0xFF000000 | rng.integers(0, 1 << 24, (h, w))).astype(np.uint32)
            pool.add(img, UV_CLAMP if i % 2 else UV_WRAP)
    soup = TriangleSoup(verts=verts, uvs=rng.uniform(-2, 3, (n, 3, 2)).astype(np.float32),
                        types=types, rgb=rng.random((n, 3), dtype=np.float32), tex=tex)
    return soup, pool


def e2e_soup(textured, seed):
    from obj2voxel_tpu_torch import BLEND_STRATEGY, MAX_STRATEGY, voxelize_soup

    soup, pool = random_soup(20_000, textured, seed)
    bounds = (np.zeros(3, np.float32), np.ones(3, np.float32))
    details = []
    for strategy, name in ((MAX_STRATEGY, "max"), (BLEND_STRATEGY, "blend")):
        kw = dict(resolution=256, strategy=strategy, bounds=bounds,
                  max_pass_budget=1 << 14)
        gpu = voxel_dict(voxelize_soup(soup, pool, **kw))
        cpu = voxel_dict(voxelize_soup(soup, pool, device="cpu", **kw))
        details.append(f"{name}: " + compare_voxels(
            gpu, cpu, strategy == BLEND_STRATEGY, f"E2E {name}"))
    return details


OPTION_CASES = (
    ("merge_runs", dict(resolution=256, merge_runs=True)),
    ("supersampling 2", dict(resolution=128, supersampling=2)),
    ("input-area weights", dict(resolution=256, input_area_weights=True)),
)


def e2e_options():
    """This slice's options on 5000-triangle seeded soups, untextured and
    textured, card against CPU."""
    from obj2voxel_tpu_torch import BLEND_STRATEGY, MAX_STRATEGY, voxelize_soup

    bounds = (np.zeros(3, np.float32), np.ones(3, np.float32))
    details = []
    for textured, seed in ((False, 15), (True, 16)):
        soup, pool = random_soup(5000, textured, seed)
        for name, opts in OPTION_CASES:
            for strategy, sname in ((MAX_STRATEGY, "max"), (BLEND_STRATEGY, "blend")):
                kw = dict(strategy=strategy, bounds=bounds, max_pass_budget=1 << 14,
                          **opts)
                gpu = voxel_dict(voxelize_soup(soup, pool, **kw))
                cpu = voxel_dict(voxelize_soup(soup, pool, device="cpu", **kw))
                what = f"{'textured' if textured else 'untextured'} {name} {sname}"
                details.append(f"{what}: " + compare_voxels(
                    gpu, cpu, strategy == BLEND_STRATEGY, f"E2E {what}"))
    return details


def phase_e2e():
    t0 = time.perf_counter()
    details = e2e_soup(False, 5) + e2e_options()
    with tempfile.TemporaryDirectory() as tmp:
        details.append(instance_and_cli(write_obj(Path(tmp)), supersampling=2))
    phase("5 end-to-end cuda vs cpu", t0, "; ".join(details))


def write_obj(d, n=300, seed=13):
    """A small OBJ: flat-colored faces from an MTL, and faces without a
    material but with UVs, which an Instance textures with its fallback
    texture (no image file, so no PIL)."""
    rng = np.random.default_rng(seed)
    verts = (rng.random((n, 1, 3)) + rng.uniform(-0.05, 0.05, (n, 3, 3))).reshape(-1, 3)
    uvs = rng.uniform(-1.5, 2.5, (n * 3, 2))
    lines = ["mtllib m.mtl"] + [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"vt {u:.6f} {v:.6f}" for u, v in uvs]
    for i in range(n):
        if i == n // 3:
            lines.append("usemtl green")
        elif i == 2 * n // 3:
            lines.append("usemtl none")
        a, b, c = 3 * i + 1, 3 * i + 2, 3 * i + 3
        lines.append(f"f {a}/{a} {b}/{b} {c}/{c}")
    (d / "m.obj").write_text("\n".join(lines) + "\n")
    (d / "m.mtl").write_text("newmtl green\nKd 0.2 0.7 0.3\n")
    return d / "m.obj"


def instance_and_cli(obj, supersampling=1):
    """`Instance` (with a fallback texture) and the CLI on the OBJ at r = 96,
    on the card and on the CPU: their bytes must be equal."""
    import obj2voxel_tpu_torch as pt

    outs = {}
    for device in ("cuda", "cpu"):
        rng = np.random.default_rng(14)
        inst = pt.Instance(device)
        tex = pt.Texture()
        tex.load_pixels(rng.integers(0, 256, 5 * 7 * 3, dtype=np.uint8), 5, 7, 3)
        inst.set_texture(tex)
        inst.set_input_file(str(obj))
        inst.set_output_memory("vl32")
        inst.set_resolution(96)
        inst.set_supersampling(supersampling)
        if inst.voxelize() != pt.ERR_OK:
            fail(f"Instance on {device} failed")
        outs[device] = inst.get_output_memory()
    if outs["cuda"] != outs["cpu"]:
        fail("Instance: VL32 bytes differ between the card and the cpu")
    n_inst = len(outs["cuda"]) // 16
    plys = []
    for i, device in enumerate(("cuda", "cpu")):
        plys.append(obj.parent / f"{i}.ply")
        cmd = [sys.executable, "-m", "obj2voxel_tpu_torch.cli", str(obj),
               str(plys[-1]), "-r", "96", "--device", device]
        cmd += ["-u"] if supersampling == 2 else []
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                              cwd=Path(__file__).resolve().parent)
        if proc.returncode != 0:
            fail(f"CLI on {device}: {proc.stdout}{proc.stderr}")
    ply = [p.read_bytes() for p in plys]
    if ply[0] != ply[1]:
        fail("CLI: PLY bytes differ between cuda and cpu")
    return (f"Instance (fallback texture, supersampling {supersampling}) {n_inst} "
            f"voxels, bytes equal; CLI{' -u' if supersampling == 2 else ''} PLY "
            f"{len(ply[0])} bytes equal")


def phase_e2e_textured():
    t0 = time.perf_counter()
    details = e2e_soup(True, 7)
    with tempfile.TemporaryDirectory() as tmp:
        details.append(instance_and_cli(write_obj(Path(tmp))))
    phase("11 textured end-to-end cuda vs cpu", t0, "; ".join(details))


def phase_closed_forms():
    from obj2voxel_tpu_torch import TriangleSoup, voxelize_soup

    t0 = time.perf_counter()
    corners = np.array([[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
                        [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], np.float32)
    quads = [[0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1], [2, 3, 7, 6],
             [0, 2, 6, 4], [1, 5, 7, 3]]
    tris = np.stack([corners[[q[0], q[1], q[2]]] for q in quads]
                    + [corners[[q[0], q[2], q[3]]] for q in quads])
    soup = TriangleSoup.from_vertices(tris)
    details = []
    for r, want in ((1024, 6_279_176), (2048, 25_141_256)):
        # the device is the default: CUDA
        got = sum(x.shape[0] for x, _ in voxelize_soup(soup, resolution=r))
        if got != want or want != 8 + 12 * (r - 2) + 6 * (r - 2) ** 2:
            fail(f"cube r={r}: {got} voxels, want {want}")
        details.append(f"r{r}:{got}")
    phase("6 closed forms (unit cube)", t0, " ".join(details))


def sphere_slabs(table, pool, aabb, is_blend, stride=SPHERE_RES, **kw):
    """One run of a main path over the sphere table: stream_slabs's
    (xyz, argb, count) per slab, the outputs kept on the device."""
    import obj2voxel_tpu_torch as pt
    from obj2voxel_tpu_torch.engine import MAX_PASS_BUDGET

    return pt.stream_slabs(table, pool, aabb_host=aabb, stride=stride,
                           z_extent=stride, is_blend=is_blend,
                           pair_tile=MAX_PASS_BUDGET, device_outputs=True, **kw)


def drive_sphere(table, pool, aabb, is_blend, check, **kw):
    """One run of a main path; returns (voxel count, the sum of `check` over
    the slabs' outputs, read back once at the end)."""
    voxels, checks = 0, []
    for xyz, argb, count in sphere_slabs(table, pool, aabb, is_blend, **kw):
        voxels += count
        checks.append(check(xyz[:count], argb[:count]))
    total = int(torch.stack(checks).sum().item()) if checks else 0
    torch.cuda.synchronize()
    return voxels, total


def touch(xyz, argb):
    """Touch every output byte on the device."""
    return argb.view(torch.int32).sum() + xyz.sum()


def timed_runs(fn, want, what, n=3):
    """Host seconds of n runs of fn, each ending in a synchronize; each must
    return `want`."""
    times = []
    for _ in range(n):
        t = time.perf_counter()
        if fn() != want:
            fail(f"{what}: output changed between runs")
        times.append(time.perf_counter() - t)
    return times


def check_path(name, launches):
    """A main path's launch counts: each of PATH_KERNELS[name] launched,
    none of PATH_ABSENT[name]."""
    for kernel in PATH_KERNELS[name]:
        if launches[kernel] <= 0:
            fail(f"{name} main path launched {kernel} no time")
    for kernel in PATH_ABSENT[name]:
        if launches[kernel]:
            fail(f"{name} main path launched {kernel} {launches[kernel]} times")


def real_size(name, table, pool, aabb, is_blend, check, info, want=SPHERE_VOXELS,
              **kw):
    """Drive one main path with the launch counts reset just before it and
    read just after; then the warm median of 3 runs."""
    import obj2voxel_tpu_torch as pt

    pt.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    voxels, checked = drive_sphere(table, pool, aabb, is_blend, check, **kw)
    launches = dict(pt.LAUNCHES)
    if voxels != want:
        fail(f"{name} sphere: {voxels} voxels, want {want}")
    check_path(name, launches)
    if launches["combine_pack"] >= launches["fused_pass"]:
        # a slab merge runs combine_pack once or twice over its passes; as
        # many as the passes means a compaction per pass
        fail(f"{name} main path compacted per pass: {launches}")
    times = timed_runs(lambda: drive_sphere(table, pool, aabb, is_blend, check, **kw),
                       (voxels, checked), f"{name} sphere")
    med = sorted(times)[1]
    peak = torch.cuda.max_memory_allocated() / 2**30
    return launches, checked, (f"{voxels} voxels; warm median {med:.4f} s = "
                      f"{SPHERE_TRIS / med / 1e6:.3f} Mtri/s, {voxels / med / 1e6:.3f} "
                      f"Mvox/s; runs {[round(x, 4) for x in times]}; peak "
                      f"{peak:.2f} GiB; launches {launches}; on {info}")


def phase_real_size(info):
    import obj2voxel_tpu_torch as pt

    t0 = time.perf_counter()
    table_np, aabb = sphere_table(SPHERE_TRIS, SPHERE_RES)
    table = pt.table_from_numpy(table_np, "cuda")
    launches, _, detail = real_size("untextured", table, None, aabb, True, touch,
                                    info)
    phase("7 real size (2M-tri sphere @ 1024^3 BLEND)", t0, detail)
    return launches


def phase_merge_runs(info):
    """The untextured sphere through the merge-runs route (K6): every slab
    equal to the default route's, then both routes timed in turns."""
    import obj2voxel_tpu_torch as pt

    t0 = time.perf_counter()
    table_np, aabb = sphere_table(SPHERE_TRIS, SPHERE_RES)
    table = pt.table_from_numpy(table_np, "cuda")
    routes = [[(xyz[:c], argb[:c]) for xyz, argb, c in
               sphere_slabs(table, None, aabb, True, merge_runs=flag)]
              for flag in (False, True)]
    if len(routes[0]) != len(routes[1]) or not all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(*routes)):
        fail("merge-runs sphere: slabs differ from the default route's")
    n_slabs = len(routes[0])
    del routes
    launches, _, detail = real_size("merge_runs", table, None, aabb, True, touch,
                                    info, merge_runs=True)
    # the A/B in turns: default, merge-runs, merge-runs, default, ...
    want = drive_sphere(table, None, aabb, True, touch)
    ab = {False: [], True: []}
    for flag in (False, True, True, False, False, True):
        ab[flag] += timed_runs(lambda: drive_sphere(table, None, aabb, True, touch,
                                                    merge_runs=flag),
                               want, "merge-runs A/B", n=1)
    med = {flag: sorted(t)[1] for flag, t in ab.items()}
    ratio = med[True] / med[False]
    verdict = (f"the merge-runs route still loses, {100 * (ratio - 1):.1f}% slower"
               if ratio > 1 else
               f"the merge-runs route wins, {100 * (1 - ratio):.1f}% faster")
    phase("14 real size merge-runs (2M-tri sphere @ 1024^3 BLEND, K6)", t0,
          f"{detail}; {n_slabs} slabs equal to the default route's; in turns "
          f"default {med[False]:.4f} s (runs {[round(x, 4) for x in ab[False]]}), "
          f"merge-runs {med[True]:.4f} s (runs {[round(x, 4) for x in ab[True]]}): "
          f"{verdict} (the default is unchanged)")
    return launches


def phase_supersampled(info):
    """bench.py's sphere built at stride 2048 (the CLI's -r 1024 -u) through
    stream_slabs(do_down=True) under MAX: its voxel set is the per-axis
    halving of the same table's output at 2048^3, every voxel white."""
    import obj2voxel_tpu_torch as pt

    t0 = time.perf_counter()
    fine_res = 2 * SPHERE_RES
    table_np, aabb = sphere_table(SPHERE_TRIS, fine_res)
    table = pt.table_from_numpy(table_np, "cuda")

    def coarse_keys(slabs, shift):
        keys = []
        for xyz, _, c in slabs:
            v = xyz[:c].to(torch.int64) >> shift
            keys.append((v[:, 2] * SPHERE_RES + v[:, 1]) * SPHERE_RES + v[:, 0])
        return torch.cat(keys)

    fine = coarse_keys(sphere_slabs(table, None, aabb, False, stride=fine_res), 1)
    n_fine = fine.numel()
    want = torch.unique(fine)
    del fine
    got = coarse_keys(sphere_slabs(table, None, aabb, False, stride=fine_res,
                                   do_down=True), 0)
    if got.numel() != want.numel() or not torch.equal(torch.sort(got)[0], want):
        fail("supersampled sphere: voxels differ from the halved 2048^3 output")

    def not_white(xyz, argb):
        return (argb.view(torch.int32) != -1).sum()

    launches, bad, detail = real_size(
        "supersampled", table, None, aabb, False, not_white, info,
        want=want.numel(), stride=fine_res, do_down=True)
    if bad:
        fail(f"supersampled sphere: {bad} voxels not 0xFFFFFFFF")
    phase("15 real size supersampled (2M-tri sphere @ 2048^3 -> 1024^3 MAX)", t0,
          f"{detail}; the halving of {n_fine} voxels at 2048^3; all ARGB 0xFFFFFFFF")
    return launches


def phase_real_size_textured(info):
    import obj2voxel_tpu_torch as pt
    from obj2voxel_tpu_torch.ops.color import upload_pool

    t0 = time.perf_counter()
    table_np, aabb = sphere_table(SPHERE_TRIS, SPHERE_RES, textured=True)
    table = pt.table_from_numpy(table_np, "cuda")
    pool, palette = palette_pool()
    pool_dev = upload_pool(pool, "cuda")
    allowed = torch.from_numpy(palette.view(np.int32)).cuda()

    def off_palette(xyz, argb):
        # voxels whose ARGB is not 0xFF000000 | a palette color
        return (~torch.isin(argb.view(torch.int32), allowed)).sum()

    launches, bad, detail = real_size("textured", table, pool_dev, aabb, False,
                                      off_palette, info)
    if bad:
        fail(f"textured sphere: {bad} voxels off the palette")
    del table, pool_dev

    # the same textured sphere through the user's entry point: the bytes
    # of the CPU runs of both packages
    from obj2voxel_tpu_torch.constants import TRI_TEXTURED
    from obj2voxel_tpu_torch.utils.meshes import make_sphere_mesh

    tris, uvs = make_sphere_mesh(SPHERE_TRIS, uvs=True)
    n = tris.shape[0]
    soup = pt.TriangleSoup(tris, uvs, np.full(n, TRI_TEXTURED, np.int32),
                           np.ones((n, 3), np.float32), np.zeros(n, np.int32))
    inst = pt.Instance()
    inst.set_input_soup(soup, pool)
    inst.set_output_memory("vl32")
    inst.set_resolution(SPHERE_RES)
    t = time.perf_counter()
    if inst.voxelize() != pt.ERR_OK:
        fail("Instance on the textured sphere failed")
    inst_s = time.perf_counter() - t
    data = inst.get_output_memory()
    n_inst = len(data) // 16
    if n_inst != INSTANCE_SPHERE_VOXELS:
        fail(f"Instance textured sphere: {n_inst} voxels, want {INSTANCE_SPHERE_VOXELS}")
    if hashlib.sha256(data).hexdigest() != INSTANCE_SPHERE_SHA256:
        fail("Instance textured sphere: VL32 bytes differ from the CPU runs'")
    phase("12 real size textured (2M-tri sphere, 4096^2 REPEAT texture @ "
          "1024^3 MAX)", t0, f"{detail}; all ARGB on the {PALETTE}-color "
          f"palette; Instance.set_input_soup -> VL32 in memory: {n_inst} voxels "
          f"in {inst_s:.3f} s, bytes equal to the CPU runs'")
    return launches


def batch_meshes(n=BATCH_MESHES, seed=0):
    """BASELINE.md config 5 as scripts/scale_proof.py builds it: n UV spheres
    of randint(50, 400) triangles, each scaled by uniform(0.5, 1.5), drawn
    from RandomState(seed); (T, 3, 3) float32 vertex arrays."""
    from obj2voxel_tpu_torch.utils.meshes import make_sphere_mesh

    rng = np.random.RandomState(seed)
    meshes = []
    for _ in range(n):
        n_tris = int(rng.randint(50, 400))
        meshes.append(make_sphere_mesh(n_tris) * rng.uniform(0.5, 1.5))
    return meshes


def batch_digest(results):
    """(total voxels, non-empty meshes, sha256 over every mesh's count, xyz
    (little-endian int32) and argb (little-endian uint32) in order)."""
    h = hashlib.sha256()
    for xyz, argb in results:
        h.update(np.int64(xyz.shape[0]).tobytes())
        h.update(np.ascontiguousarray(xyz, "<i4").tobytes())
        h.update(np.ascontiguousarray(argb, "<u4").tobytes())
    return (sum(x.shape[0] for x, _ in results),
            sum(1 for x, _ in results if x.shape[0]), h.hexdigest())


def phase_batch(info):
    """Config 5 through `voxelize_batch` on the card: 1000/1000 meshes
    non-empty, the count and digest of the CPU runs, K1 and combine_pack
    launched; then the warm median of 3 runs."""
    import obj2voxel_tpu_torch as pt
    from obj2voxel_tpu_torch.engine import prepare_soup

    t0 = time.perf_counter()
    soups = [pt.TriangleSoup.from_vertices(t) for t in batch_meshes()]
    n_tris = sum(len(x) for x in soups)

    def run():
        return pt.voxelize_batch(soups, resolution=BATCH_RES)

    pt.reset_launches()
    results = run()
    launches = dict(pt.LAUNCHES)
    check_path("batch", launches)
    voxels, nonempty, digest = batch_digest(results)
    if nonempty != BATCH_MESHES:
        fail(f"batch: {nonempty}/{BATCH_MESHES} meshes non-empty")
    if (voxels, digest) != (BATCH_VOXELS, BATCH_SHA256):
        fail(f"batch: {voxels} voxels, sha256 {digest}; want {BATCH_VOXELS}, "
             f"{BATCH_SHA256} (the CPU runs')")
    del results
    times = timed_runs(lambda: sum(x.shape[0] for x, _ in run()), voxels, "batch")
    med = sorted(times)[1]
    # the per-mesh host work alone (normalize, subdivide), as voxelize_batch
    # does it before the stream
    t = time.perf_counter()
    for soup in soups:
        prepare_soup(soup, BATCH_RES)
    host = time.perf_counter() - t
    phase(f"17 batch ({BATCH_MESHES} spheres @ {BATCH_RES}^3 MAX, voxelize_batch)", t0,
          f"{BATCH_MESHES}/{BATCH_MESHES} non-empty, {voxels} voxels, {n_tris} "
          f"triangles, sha256 equal to the CPU runs'; warm median {med:.4f} s = "
          f"{BATCH_MESHES / med:.1f} meshes/s; runs {[round(x, 4) for x in times]}; "
          f"per-mesh host prep alone {host:.4f} s; launches {launches}; on {info}")
    return launches


def sorted_voxels(batches):
    """Concatenated (xyz, argb) batches as (linear keys, argb) numpy arrays
    sorted by key; fails on a voxel given twice."""
    xyz = np.concatenate([x for x, _ in batches]).astype(np.int64)
    argb = np.concatenate([a for _, a in batches])
    keys = (xyz[:, 2] * SPHERE_RES + xyz[:, 1]) * SPHERE_RES + xyz[:, 0]
    order = np.argsort(keys, kind="stable")
    keys, argb = keys[order], argb[order]
    if keys.size and (np.diff(keys) == 0).any():
        fail("sharded sphere: a voxel was emitted twice")
    return keys, argb


def phase_sharded(info):
    """bench.py's sphere as a TriangleSoup through `stream_sharded` with its
    windows repeated on the one card: BLEND in 2 windows, MAX in 3 with the
    merge-runs route, each against `voxelize_soup` of the same soup and
    options on the card (the voxel set exactly, MAX bytes exactly, BLEND
    within 1 LSB)."""
    import os

    import obj2voxel_tpu_torch as pt
    from obj2voxel_tpu_torch.constants import BLEND_STRATEGY, MAX_STRATEGY
    from obj2voxel_tpu_torch.parallel.mesh import stream_sharded
    from obj2voxel_tpu_torch.utils.meshes import make_sphere_mesh

    t0 = time.perf_counter()
    soup = pt.TriangleSoup.from_vertices(make_sphere_mesh(SPHERE_TRIS))
    cases = ((BLEND_STRATEGY, 2, "0"), (MAX_STRATEGY, 3, "1"))
    before = os.environ.get("O2V_MERGE_RUNS")
    details, launches = [], {}
    try:
        pt.reset_launches()
        runs = []
        for strategy, n_win, merge_runs in cases:
            os.environ["O2V_MERGE_RUNS"] = merge_runs
            t = time.perf_counter()
            got = sorted_voxels(list(stream_sharded(
                soup, resolution=SPHERE_RES, strategy=strategy,
                devices=["cuda:0"] * n_win)))
            runs.append((got, time.perf_counter() - t))
        launches = dict(pt.LAUNCHES)
        check_path("sharded", launches)
        for (strategy, n_win, merge_runs), (got, secs) in zip(cases, runs):
            os.environ["O2V_MERGE_RUNS"] = "0"
            t = time.perf_counter()
            want = sorted_voxels(list(pt.voxelize_soup(
                soup, resolution=SPHERE_RES, strategy=strategy)))
            one = time.perf_counter() - t
            blend = strategy == BLEND_STRATEGY
            if not np.array_equal(got[0], want[0]):
                fail(f"sharded sphere x{n_win}: voxel sets differ ({got[0].size} vs "
                     f"{want[0].size})")
            lsb = int(np.abs(got[1].view(np.uint8).astype(np.int16)
                             - want[1].view(np.uint8).astype(np.int16)).max())
            if lsb > (1 if blend else 0):
                fail(f"sharded sphere x{n_win}: colors differ by {lsb} LSB")
            details.append(
                f"{'BLEND' if blend else 'MAX, O2V_MERGE_RUNS=1'} in {n_win} windows: "
                f"{got[0].size} voxels, {lsb} LSB from one device; {secs:.3f} s "
                f"(one device {one:.3f} s, host prep included)")
    finally:
        if before is None:
            os.environ.pop("O2V_MERGE_RUNS", None)
        else:
            os.environ["O2V_MERGE_RUNS"] = before
    phase("18 multi-device windows on one card (2M-tri sphere soup @ 1024^3)", t0,
          "; ".join(details) + f"; launches {launches}; windows repeated on one "
          f"card, no multi-card number; on {info}")
    return launches


def phase_capi():
    """The port's C shim built from native/ and native/test/capi_test.c run
    on the card: the unit cube's closed form at r = 32."""
    from obj2voxel_tpu_torch.capi import build_shim, shim_env

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        exe = build_shim(Path(tmp) / "build")
        built = time.perf_counter() - t0
        proc = subprocess.run([str(exe)], env=shim_env("cuda"), capture_output=True,
                              text=True, timeout=600)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0 or f"voxels: {CUBE_32_VOXELS} expected: {CUBE_32_VOXELS}" \
            not in proc.stdout:
        fail(f"C shim on the card: exit {proc.returncode}\n{out}")
    phase("19 C shim (libobj2voxel_tpu_torch.so, capi_test on cuda)", t0,
          f"built in {built:.1f} s; unit cube r=32 -> {CUBE_32_VOXELS} voxels; "
          "ERR_NO_INPUT path checked")


def sphere_batches(table, aabb):
    """The plan-ordered sphere table and the engine's first batched launch
    of 8, 4 and 2 2^21-slot passes under O2V_BATCH=8 (`engine._waves`):
    [(expand, budget, [fused_pass args, ...], slabs)]; at least one spans
    two slabs."""
    from obj2voxel_tpu_torch.engine import WAVE_CAP_ROWS, _waves
    from obj2voxel_tpu_torch.ops.plan_device import gather_ordered, plan_mesh_device

    order, segs = plan_mesh_device(table, aabb[0].shape[0], SPHERE_RES,
                                   SPHERE_RES, 4 * BUDGET, group=8)
    ordered = gather_ordered(table, order, segs[-1].r1, 8)
    slabs = {}
    for seg in segs:
        slabs.setdefault((seg.z_lo, seg.z_hi), []).append(seg)
    picked = {}
    for _, dispatches in _waves(list(slabs.items()), SPHERE_RES, BUDGET,
                                WAVE_CAP_ROWS, 8):
        for expand, budget, _, items in dispatches:
            if budget == BUDGET and len(items) > 1:
                picked.setdefault(len(items), (
                    expand, budget, [d for _, _, d in items],
                    len({slab for slab, _, _ in items})))
    if sorted(picked) != [2, 4, 8] or max(b[3] for b in picked.values()) < 2:
        fail(f"sphere schedule: no batched launches of 8, 4 and 2 passes across "
             f"slabs ({picked})")
    return ordered, [picked[n] for n in (8, 4, 2)]


def compare_batch(got, want, what):
    """Batched K1 outputs against (B, budget) stacks of the same: the counts,
    then each row's first count entries, key and channels, bit for bit (the
    entries past a count are undefined); returns the live pairs."""
    if not torch.equal(got[5], want[5]):
        fail(f"{what}: counts {got[5].tolist()} != {want[5].tolist()}")
    counts = want[5].tolist()
    for g, w, name in zip(got, want, ("keys", "w", "wr", "wg", "wb")):
        for b, n in enumerate(counts):
            if not torch.equal(g[b, :n].view(torch.int32), w[b, :n].view(torch.int32)):
                fail(f"{what}: {name} of pass {b} differ")
    return sum(counts)


def batch_vs_plain_and_single(table, passes, what, **kw):
    """One batched launch against its plain version and against one K1
    launch a pass; returns its outputs and live pairs."""
    from obj2voxel_tpu_torch.ops.pass_fused import (
        fused_pass, fused_pass_batch, fused_pass_batch_ref,
    )

    got = fused_pass_batch(table, passes, **kw)
    n = compare_batch(got, fused_pass_batch_ref(table, passes, **kw), f"{what} vs plain")
    singles = [fused_pass(table, *p, **kw) for p in passes]
    compare_batch(got, [torch.stack([o[j] for o in singles]) for j in range(5)]
                  + [torch.cat([o[5] for o in singles])], f"{what} vs single")
    return got, n


def ptxas_usage(kernel):
    """Registers and spill stores of `kernel` in phase 1's ptxas report, and
    its lines."""
    import re

    from obj2voxel_tpu_torch.ops import _cuda

    lines = _cuda.resource_log_path().read_text().splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            text = " ".join(x.strip() for x in lines[i + 1:i + 3])
            spills = re.search(r"(\d+) bytes spill stores", text)
            regs = re.search(r"Used (\d+) registers", text)
            if spills and regs:
                return int(regs.group(1)), int(spills.group(1)), text
    fail(f"ptxas report: no registers or spills for {kernel}")


def phase_k1_batch(stats):
    """K1's batched form bit for bit against its plain version and against
    one K1 launch a pass, on the counts and each pass's live rows: the
    sphere's batched launches of 8, 4 and 2 passes, with and without
    ref_weights; one batch of each size 2 to 8; a batch holding a pass with
    no live pair; 50 launches of one batch of 8, all equal.  Then its time
    for 8 passes and for 1 beside single launches in turns, its plain
    version and its bound; in its ptxas report no spill and at most 64
    registers."""
    from obj2voxel_tpu_torch.ops.clip_pallas import pass_pairs
    from obj2voxel_tpu_torch.ops.pass_fused import (
        fused_pass, fused_pass_batch, fused_pass_batch_ref,
    )

    t0 = time.perf_counter()
    # no spill, and at most 64 registers: 4 blocks of 256 threads an SM
    regs, spills, line = ptxas_usage("fused_pass_batch_kernel")
    if spills or regs > 64:
        fail(f"fused_pass_batch_kernel: {line}")
    table_np, aabb = sphere_table(SPHERE_TRIS, SPHERE_RES)
    ordered, batches = sphere_batches(torch.from_numpy(table_np).cuda(), aabb)
    details = [f"ptxas {line}"]
    for expand, budget, passes, n_slabs in batches:
        for ref in (False, True):
            _, n = batch_vs_plain_and_single(
                ordered, passes, f"K1 batch of {len(passes)} at expand {expand} "
                f"ref_weights={ref}", expand=expand, budget=budget, ref_weights=ref)
            details.append(f"B{len(passes)} e{expand} {n_slabs} slabs"
                           f"{' ref_weights' if ref else ''}: {n} pairs")
    expand, budget, passes, _ = batches[0]
    kw = dict(expand=expand, budget=budget)
    sizes = []
    for nb in range(2, 9):
        _, n = batch_vs_plain_and_single(ordered, passes[-nb:], f"K1 batch of {nb}", **kw)
        sizes.append(f"{nb}:{n}")
    details.append("sizes " + " ".join(sizes))
    # pass 3's rows in a z window that none of them reaches: 0 live pairs
    r0, n_rows, local_base, z_lo, z_hi, stride = passes[3]
    far = (0, 16) if z_lo >= SPHERE_RES // 2 else (SPHERE_RES - 16, SPHERE_RES)
    empty = [*passes[:3], (r0, n_rows, local_base, *far, stride), *passes[4:]]
    got, n = batch_vs_plain_and_single(ordered, empty, "K1 batch with an empty pass", **kw)
    if got[5][3].item() != 0 or n == 0:
        fail(f"K1 batch with an empty pass: counts {got[5].tolist()}")
    details.append(f"empty pass 3 (z {far}): counts {got[5].tolist()}")
    first = fused_pass_batch(ordered, passes, **kw)
    for i in range(50):
        compare_batch(fused_pass_batch(ordered, passes, **kw), first,
                      f"K1 batch of 8, launch {i + 1} of 50")
    details.append("50 launches of 8 equal")
    batch_ms, single_ms, turns = in_turns(
        lambda: fused_pass_batch(ordered, passes, **kw),
        lambda: [fused_pass(ordered, *p, **kw) for p in passes])
    one_ms, one_single_ms, one_turns = in_turns(
        lambda: fused_pass_batch(ordered, passes[:1], **kw),
        lambda: fused_pass(ordered, *passes[0], **kw))
    counts = first[5].tolist()
    stats["fused_pass_batch"].update(
        ms=batch_ms, single_ms=single_ms, b1_ms=one_ms, b1_single_ms=one_single_ms,
        plain_ms=cuda_ms(lambda: fused_pass_batch_ref(ordered, passes, **kw), reps=1),
        library_ms=None, max_abs_err=0.0)
    # as phase 2 counts one pass: the 12 columns read of each row, 20 B per
    # live pair written and the count; the clip, the AABB and rank decode
    # and the premultiply per slot in its AABB, over the 8 passes
    n_bytes = n_ops = 0
    table_t = ordered.T.contiguous()
    for p, n in zip(passes, counts):
        tri, vox, _, _, valid = pass_pairs(table_t, *p, wide_local=False, **kw)
        n_bytes += p[1] * 48 + n * 20 + 4
        n_ops += clip_flops(tri, vox, valid, 3) + 28 * int(valid.sum())
        del tri, vox, valid
    bound(stats, "fused_pass_batch", n_bytes, n_ops)
    phase("20 K1 fused_pass_batch vs plain and single K1 launches", t0,
          "; ".join(details) + f"; 8 passes in {batch_ms:.4f} ms, 8 single "
          f"launches {single_ms:.4f} ms in turns {[round(x, 4) for x in turns]}; "
          f"1 pass in {one_ms:.4f} ms, 1 single launch {one_single_ms:.4f} ms in "
          f"turns {[round(x, 4) for x in one_turns]}")


def slab_outputs(table, aabb, is_blend, **kw):
    """One run of a sphere path: each slab's (xyz, argb) on the device."""
    return [(xyz[:c], argb[:c]) for xyz, argb, c in
            sphere_slabs(table, None, aabb, is_blend, **kw)]


def batched_env(cap):
    """Set O2V_BATCH (None: unset it); returns the previous value."""
    import os

    before = os.environ.get("O2V_BATCH")
    if cap is None:
        os.environ.pop("O2V_BATCH", None)
    else:
        os.environ["O2V_BATCH"] = str(cap)
    return before


def batched_path(name, run, same):
    """One path under O2V_BATCH=8: the launch counts reset just before one
    run and read just after, gated (K1's batched form launched, fewer K1
    dispatches than passes); `same(out)` checks the run's output; then
    O2V_BATCH=1 and =8 timed in turns (1, 8, 8, 1, 1, 8).  Returns the
    launches and a detail string."""
    import obj2voxel_tpu_torch as pt
    from obj2voxel_tpu_torch.engine import WAVE_STATS

    batched_env(8)
    pt.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    launches = dict(pt.LAUNCHES)
    wave = dict(WAVE_STATS)
    peak = {8: torch.cuda.max_memory_allocated() / 2**30}
    check_path("batched", launches)
    k1 = launches["fused_pass"] + launches["fused_pass_batch"]
    if k1 >= wave["passes"] or k1 != wave["dispatches"]:
        fail(f"batched {name}: {k1} K1 dispatches for {wave['passes']} passes "
             f"({launches}, {wave})")
    same(out)
    del out
    times = {1: [], 8: []}
    for cap in (1, 8, 8, 1, 1, 8):
        batched_env(cap)
        if cap not in peak:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times[cap].append(time.perf_counter() - t)
        peak.setdefault(cap, torch.cuda.max_memory_allocated() / 2**30)
    med = {cap: sorted(t)[1] for cap, t in times.items()}
    return launches, (
        f"{name}: {wave}; launches {launches}; in turns O2V_BATCH=1 {med[1]:.4f} s "
        f"(runs {[round(x, 4) for x in times[1]]}), O2V_BATCH=8 {med[8]:.4f} s "
        f"(runs {[round(x, 4) for x in times[8]]}): {med[8] / med[1]:.3f}x; peak "
        f"{peak[1]:.2f} GiB unbatched, {peak[8]:.2f} GiB batched")


def phase_batched_paths(info):
    """The sphere (BLEND), the supersampled sphere (2048^3 -> 1024^3 MAX)
    and phase 17's batch under O2V_BATCH=8: each with the bytes of
    O2V_BATCH=1 (the sphere's 4,936,255 voxels; the batch's count and
    sha256 of the CPU runs), K1's batched form launched and fewer K1
    dispatches than passes; both settings timed in turns."""
    import obj2voxel_tpu_torch as pt

    t0 = time.perf_counter()
    before = batched_env(None)
    details, total = [], {name: 0 for name in KERNELS}
    try:
        for name, res, is_blend, kw in (
                ("sphere", SPHERE_RES, True, {}),
                ("supersampled sphere", 2 * SPHERE_RES, False,
                 dict(stride=2 * SPHERE_RES, do_down=True))):
            table_np, aabb = sphere_table(SPHERE_TRIS, res)
            table = pt.table_from_numpy(table_np, "cuda")
            batched_env(1)
            want = slab_outputs(table, aabb, is_blend, **kw)
            n_want = sum(x.shape[0] for x, _ in want)
            if name == "sphere" and n_want != SPHERE_VOXELS:
                fail(f"sphere: {n_want} voxels, want {SPHERE_VOXELS}")

            def same(got, want=want, name=name):
                if len(got) != len(want) or not all(
                        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                        for a, b in zip(got, want)):
                    fail(f"batched {name}: slabs differ from O2V_BATCH=1's")

            launches, detail = batched_path(
                name, lambda: slab_outputs(table, aabb, is_blend, **kw), same)
            details.append(f"{detail}; {n_want} voxels, bytes equal to O2V_BATCH=1")
            for k in total:
                total[k] += launches[k]
            del table, want

        soups = [pt.TriangleSoup.from_vertices(t) for t in batch_meshes()]

        def same_batch(results):
            voxels, nonempty, digest = batch_digest(results)
            if (voxels, nonempty, digest) != (BATCH_VOXELS, BATCH_MESHES, BATCH_SHA256):
                fail(f"batched batch: {voxels} voxels, {nonempty} non-empty, sha256 "
                     f"{digest}; want {BATCH_VOXELS}, {BATCH_SHA256}")

        launches, detail = batched_path(
            "batch", lambda: pt.voxelize_batch(soups, resolution=BATCH_RES),
            same_batch)
        details.append(f"{detail}; {BATCH_VOXELS} voxels, sha256 of the CPU runs")
        for k in total:
            total[k] += launches[k]
    finally:
        batched_env(before)
    phase("20 batched paths under O2V_BATCH=8 (sphere, supersampled sphere, "
          "config 5)", t0, "; ".join(details) + f"; on {info}")
    return total


@contextlib.contextmanager
def env_var(name, value):
    """Set (or with None unset) one environment variable for a block."""
    before = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = before


def bench_mode(mode, n_tris, want, info, **kw):
    """One bench entry mode at 1024^3 on the card (a warm run, then 3 timed
    runs, each asserted to give the warm run's count): gated on `want`
    voxels; prints its bench.py JSON line.  Returns a detail string."""
    from obj2voxel_tpu_torch import bench

    t = time.perf_counter()
    if mode == "host":
        n, voxels, times = bench.run_host(n_tris, SPHERE_RES)
    else:
        n, voxels, times = bench.run_device_resident(
            n_tris, SPHERE_RES, pull=mode == "pull", **kw)
    if voxels != want:
        fail(f"bench {mode} ({n_tris} triangles): {voxels} voxels, want {want}")
    med = sorted(times)[1]
    print(f"[bench] {json.dumps(bench.result_line(n, voxels, med, SPHERE_RES, mode))} "
          f"({info})", flush=True)
    return (f"{mode} {n} tris: {voxels} voxels, median {med:.4f} s = "
            f"{n / med / 1e6:.3f} Mtri/s (runs {[round(x, 4) for x in times]}; "
            f"{time.perf_counter() - t:.1f} s with its set-up)")


def phase_bench(info):
    """The bench entry (obj2voxel_tpu_torch.bench, bench.py's counterpart)
    on the card: device, pull and host mode on the 2M-triangle sphere at
    1024^3 BLEND (device and pull 4,936,255 voxels; host its CPU run's
    count), then device and pull mode on the 10M-triangle table, whose
    voxel set must be its CPU run's (count and sha256)."""
    import obj2voxel_tpu_torch as pt
    from obj2voxel_tpu_torch import bench

    t0 = time.perf_counter()
    pt.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    want = {"device": SPHERE_VOXELS, "pull": SPHERE_VOXELS, "host": HOST_SPHERE_VOXELS}
    details = [bench_mode(mode, SPHERE_TRIS, want[mode], info) for mode in bench.MODES]
    peak2 = torch.cuda.max_memory_allocated() / 2**30
    t = time.perf_counter()
    sphere = bench.upload_sphere(SPHERE_10M_TRIS, SPHERE_RES, "cuda")
    built = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    got = bench.sphere_occupancy(sphere, SPHERE_RES)
    if got != (SPHERE_10M_VOXELS, SPHERE_10M_SHA256):
        fail(f"bench 10M: {got}, want {SPHERE_10M_VOXELS} voxels, sha256 "
             f"{SPHERE_10M_SHA256} (the CPU run's)")
    details += [bench_mode(mode, SPHERE_10M_TRIS, SPHERE_10M_VOXELS, info,
                           sphere=sphere) for mode in ("device", "pull")]
    peak10 = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(pt.LAUNCHES)
    del sphere
    torch.cuda.empty_cache()
    check_path("bench", launches)
    if launches["combine_pack"] >= launches["fused_pass"]:
        fail(f"bench main path compacted per pass: {launches}")
    phase("21 bench entry (2M-tri sphere @ 1024^3 device, pull, host; 10M device, "
          "pull)",
          t0, "; ".join(details) + f"; 10M table built and uploaded in {built:.2f} s, "
          f"its voxel set equal to the CPU run's; peak {peak2:.2f} GiB (2M), "
          f"{peak10:.2f} GiB (10M); launches {launches}; on {info}")
    return launches


def argb_all(path, value):
    """Whether every voxel of a VL32 file has ARGB `value`."""
    return bool((np.fromfile(path, ">u4").reshape(-1, 4)[:, 3] == value).all())


def check_file(result, voxels, sha256, what):
    if result["exit"] != 0 or result["voxels"] != voxels \
            or result["vl32_sha256"] != sha256:
        fail(f"{what}: exit {result['exit']}, {result['voxels']} voxels, sha256 "
             f"{result['vl32_sha256']}; want {voxels}, {sha256} (the CPU run's)")


def scale_line(config, desc, n_tris, res, result, info):
    """scripts/scale_proof.py's JSON line for a config, with this port's
    fields; printed after `[scale]`."""
    keys = ("exit", "voxels", "wall_s", "peak_rss_gb", "rss_start_gb",
            "peak_device_gib", "vl32_sha256", "wave_stats", "stage_s")
    line = {"config": config, "desc": desc, "triangles": n_tris, "resolution": res,
            **{k: result[k] for k in keys if k in result}}
    print(f"[scale] {json.dumps(line)} ({info})", flush=True)


def phase_config4(info):
    """BASELINE config 4 on the card: bench.py's 10M-triangle sphere as a
    binary STL through `Instance` into VL32 at 2048^3 (MAX): the CPU run's
    count and bytes, every voxel the STL's one ARGB, K1 and combine_pack
    launched; again under O2V_TIMING=1 for host seconds by stage (its lines
    not printed); then the same bytes from the host planner
    (O2V_HOST_PLAN=1) and from `stream_sharded` in 3 z windows on the one
    card.  Returns the launches and the first run's (peak RSS, its rise
    over the RSS at its start)."""
    import io

    import obj2voxel_tpu_torch as pt
    from obj2voxel_tpu_torch import scale
    from obj2voxel_tpu_torch.constants import MAX_STRATEGY
    from obj2voxel_tpu_torch.io.stl_loader import load_stl
    from obj2voxel_tpu_torch.io.writers import Vl32Writer
    from obj2voxel_tpu_torch.parallel.mesh import stream_sharded
    from obj2voxel_tpu_torch.utils.meshes import make_sphere_mesh, write_stl

    t0 = time.perf_counter()
    res = 2048
    with tempfile.TemporaryDirectory(prefix="o2v_config4_") as tmp:
        stl, out = os.path.join(tmp, "sphere10m.stl"), os.path.join(tmp, "out.vl32")
        tris = make_sphere_mesh(SPHERE_10M_TRIS)
        n_tris = tris.shape[0]
        write_stl(stl, tris)
        del tris
        made = time.perf_counter() - t0
        pt.reset_launches()
        first = scale.voxelize_file(stl, out, res)
        launches = dict(pt.LAUNCHES)
        check_file(first, CONFIG4_VOXELS, CONFIG4_SHA256, "config 4")
        check_path("scale_2048", launches)
        if launches["combine_pack"] >= launches["fused_pass"]:
            fail(f"config 4 compacted per pass: {launches}")
        if not argb_all(out, STL_ARGB):
            fail(f"config 4: a voxel's ARGB is not {STL_ARGB:#x}")
        with env_var("O2V_TIMING", "1"), contextlib.redirect_stdout(io.StringIO()):
            staged = scale.voxelize_file(stl, out, res)
        check_file(staged, CONFIG4_VOXELS, CONFIG4_SHA256, "config 4 (O2V_TIMING=1)")
        with env_var("O2V_HOST_PLAN", "1"):
            host = scale.voxelize_file(stl, out, res)
        check_file(host, CONFIG4_VOXELS, CONFIG4_SHA256, "config 4, O2V_HOST_PLAN=1")
        if host["wave_stats"]["host_plan"] != 1 or first["wave_stats"]["host_plan"]:
            fail(f"config 4: planners {first['wave_stats']}, {host['wave_stats']}")
        t = time.perf_counter()
        with open(out, "wb") as f:
            writer = Vl32Writer(f, res)
            for xyz, argb in stream_sharded(load_stl(stl), resolution=res,
                                            strategy=MAX_STRATEGY,
                                            devices=["cuda:0"] * 3):
                writer.write(xyz, argb)
            writer.finalize()
        sharded = time.perf_counter() - t
        if scale.file_sha256(out) != CONFIG4_SHA256:
            fail("config 4 in 3 z windows: other bytes than one device's")
    desc = f"10M-tri STL -> {res}^3 VL32 (streamed slabs)"
    scale_line(4, desc, n_tris, res, {**first, "stage_s": staged["stage_s"]}, info)
    phase("22 config 4 (10M-tri STL -> 2048^3 VL32 through Instance)", t0,
          f"{first['voxels']} voxels, sha256 equal to the CPU run's, every ARGB "
          f"{STL_ARGB:#x}; STL written in {made:.1f} s; Instance {first['wall_s']:.3f} s, "
          f"peak RSS {first['peak_rss_gb']:.3f} GB ({first['rss_start_gb']:.3f} GB at "
          f"its start), peak device "
          f"{first['peak_device_gib']:.3f} GiB; {first['wave_stats']}; with "
          f"O2V_TIMING=1 {staged['wall_s']:.3f} s, host seconds by stage "
          f"{staged['stage_s']}; "
          f"O2V_HOST_PLAN=1 the same bytes in {host['wall_s']:.3f} s; 3 z windows "
          f"the same bytes in {sharded:.3f} s (STL load included); launches "
          f"{launches}; on {info}")
    return launches, (first["peak_rss_gb"], first["peak_rss_gb"] - first["rss_start_gb"])


def phase_config6(info, config4_rss=None):
    """BASELINE config 6 on the card: scripts/scale_proof.py's 100k-triangle
    helix as a binary STL through `Instance` into VL32 at 8192^3: the CPU
    run's count and bytes, more than MAX_DEVICE_SLABS slabs planned on the
    host, every voxel the STL's one ARGB, K1 and combine_pack launched, a
    peak RSS and a rise in RSS over its start each under config 4's
    (`config4_rss`, when phase 22 ran); then once more with O2V_TIMING=1 (its lines printed, each
    wave's pass counts abbreviated) for host seconds by stage."""
    import io
    import re

    import obj2voxel_tpu_torch as pt
    from obj2voxel_tpu_torch import scale
    from obj2voxel_tpu_torch.ops.plan_device import MAX_DEVICE_SLABS
    from obj2voxel_tpu_torch.utils.meshes import make_helix_mesh, write_stl

    t0 = time.perf_counter()
    res = 8192
    with tempfile.TemporaryDirectory(prefix="o2v_config6_") as tmp:
        stl, out = os.path.join(tmp, "helix.stl"), os.path.join(tmp, "out.vl32")
        tris = make_helix_mesh(100_000)
        n_tris = tris.shape[0]
        write_stl(stl, tris)
        del tris
        pt.reset_launches()
        first = scale.voxelize_file(stl, out, res)
        launches = dict(pt.LAUNCHES)
        check_file(first, CONFIG6_VOXELS, CONFIG6_SHA256, "config 6")
        wave = first["wave_stats"]
        if wave["slabs"] <= MAX_DEVICE_SLABS or wave["host_plan"] != 1:
            fail(f"config 6 was not planned on the host past {MAX_DEVICE_SLABS} "
                 f"slabs: {wave}")
        check_path("scale_8192", launches)
        if launches["combine_pack"] >= launches["fused_pass"]:
            fail(f"config 6 compacted per pass: {launches}")
        if not argb_all(out, STL_ARGB):
            fail(f"config 6: a voxel's ARGB is not {STL_ARGB:#x}")
        buf = io.StringIO()
        with env_var("O2V_TIMING", "1"), contextlib.redirect_stdout(buf):
            staged = scale.voxelize_file(stl, out, res)
        check_file(staged, CONFIG6_VOXELS, CONFIG6_SHA256, "config 6 (O2V_TIMING=1)")
    for line in buf.getvalue().splitlines():
        print(re.sub(r"counts=\[([^\]]*)\]",
                     lambda m: f"counts=<{m.group(1).count(',') + 1} passes>", line),
              flush=True)
    peak, rise = first["peak_rss_gb"], first["peak_rss_gb"] - first["rss_start_gb"]
    if config4_rss is None:
        rss = "; RSS gate against config 4 skipped: phase 22 did not run"
    else:
        peak4, rise4 = config4_rss
        if peak >= peak4 or rise >= rise4:
            fail(f"config 6's peak RSS {peak:.3f} GB (+{rise:.3f} GB over its start) "
                 f"is not under config 4's {peak4:.3f} GB (+{rise4:.3f} GB)")
        rss = (f" (+{rise:.3f} GB; config 4: {peak4:.3f} GB, +{rise4:.3f} GB over "
               f"its start)")
    desc = f"100k-tri helix -> {res}^3 VL32 (streamed slabs, host planner)"
    scale_line(6, desc, n_tris, res, {**first, "stage_s": staged["stage_s"]}, info)
    phase("23 config 6 (100k-tri helix -> 8192^3 VL32 through Instance, host planner)",
          t0, f"{first['voxels']} voxels, sha256 equal to the CPU run's, every ARGB "
          f"{STL_ARGB:#x}; {wave['slabs']} slabs (> {MAX_DEVICE_SLABS}: host planner), "
          f"{wave}; plan order {wave['rows']} rows = {wave['rows'] * 8} B of int64 "
          f"uploaded; Instance {first['wall_s']:.3f} s, peak RSS "
          f"{first['peak_rss_gb']:.3f} GB ({first['rss_start_gb']:.3f} GB at its "
          f"start){rss}, peak device "
          f"{first['peak_device_gib']:.3f} GiB; with O2V_TIMING=1 "
          f"{staged['wall_s']:.3f} s, host seconds by stage {staged['stage_s']}; "
          f"launches {launches}; on {info}")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(map(str, sorted(ALL_PHASES))))
    want = {int(p) for p in ap.parse_args().phases.split(",")}

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on a GPU")
    info = gpu_info()
    print(f"[gpu] {info}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from obj2voxel_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build()
    _cuda.lib()
    # registers, stack frame, spills and static shared memory of each kernel
    for line in _cuda.resource_log_path().read_text().splitlines():
        if line.strip():
            print(f"[ptxas] {line.strip()}", flush=True)
    phase("1 build", t0, f"nvcc {_cuda.BUILD_SECONDS} s -> {_cuda.library_path().name}")

    stats = {name: {} for name in (*KERNELS, "fused_pass_textured")}
    by_path = {path: {name: 0 for name in KERNELS} for path in PATH_KERNELS}
    for num, fn in ((2, phase_k1), (3, phase_k2), (4, phase_k3), (16, phase_rbk),
                    (9, phase_k4), (10, phase_k5), (13, phase_k6),
                    (20, phase_k1_batch)):
        if want & {num, 8}:
            launches = fn(stats)
            if num == 9:
                by_path["clip_helper"] = launches
    if 5 in want:
        phase_e2e()
    if 11 in want:
        phase_e2e_textured()
    if 6 in want:
        phase_closed_forms()
    if 7 in want:
        by_path["untextured"] = phase_real_size(info)
    if 12 in want:
        by_path["textured"] = phase_real_size_textured(info)
    if 14 in want:
        by_path["merge_runs"] = phase_merge_runs(info)
    if 15 in want:
        by_path["supersampled"] = phase_supersampled(info)
    if 17 in want:
        by_path["batch"] = phase_batch(info)
    if 18 in want:
        by_path["sharded"] = phase_sharded(info)
    if 19 in want:
        phase_capi()
    if 20 in want:
        by_path["batched"] = phase_batched_paths(info)
    if 21 in want:
        by_path["bench"] = phase_bench(info)
    config4_rss = None
    if 22 in want:
        by_path["scale_2048"], config4_rss = phase_config4(info)
    if 23 in want:
        by_path["scale_8192"] = phase_config6(info, config4_rss)
    if 8 in want:
        for name, s in stats.items():
            lib = "none" if s["library_ms"] is None else f"{s['library_ms']:.4f} ms"
            print(f"[phase] 8 {name}: kernel {s['ms']:.4f} ms, plain "
                  f"{s['plain_ms']:.4f} ms, library {lib}, bound "
                  f"{s['bound_ms']:.4f} ms by {s['bound_by']} ({s['bytes']} B, "
                  f"{s['ops']} FP32 ops) ({info})", flush=True)
    if want != ALL_PHASES:
        print("[partial run: no result line]", flush=True)
        return
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(by_path[p][name] for p in by_path),
         "launches_by_path": {p: by_path[p][name] for p in by_path},
         **{k: stats[name][k] for k in keys}}
        for name, (src, rep) in KERNELS.items()
    ]
    # K1's textured variant: the same kernel source and launch count
    line[0]["variants"] = {"textured": {k: stats["fused_pass_textured"][k]
                                        for k in keys}}
    # K1's batched form: 8 single K1 launches, and one pass alone against one
    # K1 launch, each timed in turns beside it
    line[1]["in_turns"] = {k: stats["fused_pass_batch"][k]
                           for k in ("single_ms", "b1_ms", "b1_single_ms")}
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
