"""Where the port's time goes on one CUDA card: a torch.profiler trace of one
warm `stream_slabs` run of chip_smoke.py's 2M-triangle sphere at 1024^3,
untextured (BLEND, K1 passes), textured (MAX, K1's textured passes with
one 4096^2 REPEAT texture), untextured through the merge-runs route (BLEND,
K6) and supersampled from 2048^3 (MAX), outputs kept on the device; and of
ten calls of K1, K4, K5 and K6 alone at chip_smoke.py's timing shapes
(phases 2, 9, 10 and 13), and of the slab merge's combine (`--paths
combine`: the fused `combine_pack`, K2 and K3 alone, and the engine's call)
on phase 3's stream and on the sphere's real merge input; and of one warm
`voxelize_batch` run of phase 17's 1000 meshes (`--paths batch`: the trace,
then the host functions by cumulative time under cProfile); and of one warm
run of the bench entry's device mode on bench.py's 10M-triangle table at
1024^3 BLEND (`--paths sphere10m`, chip_smoke.py phase 21's).  `--paths
schedule` prints the pass schedule of the sphere, the supersampled sphere
and phase 17's batch under O2V_BATCH=1 and =8 (passes, waves, dispatches,
batched launches); alone it needs no card (`--paths untextured` prints the
sphere's too).

    python3 scripts/profile_port.py [--top 15] [--paths untextured,k1,k4]
    python3 scripts/profile_port.py --paths schedule

Prints, per path, the wall time of the profiled run, the device's busy time
(the union of its kernel intervals) and idle share, and the kernels with the
most device time.  Needs one CUDA device except for the schedule.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def busy_ms(events):
    """Union of the device intervals of the profiled kernels, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def traced(run):
    """One warm run of `run` under torch.profiler: (its result, the profile,
    the wall ms, the device busy ms)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    run()  # warm
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    return out, prof, wall, busy_ms(prof.events())


def by_kernel(prof, top):
    rows = [a for a in prof.key_averages() if a.device_time_total > 0]
    rows.sort(key=lambda a: a.device_time_total, reverse=True)
    for a in rows[:top]:
        print(f"  {a.device_time_total / 1e3:9.3f} ms  {a.count:5d}x  {a.key[:90]}")


def pass_schedule(table, aabb, stride, z_extent=None):
    """The passes `stream_slabs` runs on `table` (on any device) at
    `stride`: how many at each budget and their slots; then, under
    O2V_BATCH=1 and =8 (`engine._waves`, the engine's own schedule), its
    waves, dispatches, passes batched and batched launches by size."""
    from collections import Counter

    from obj2voxel_tpu_torch.engine import (
        MAX_PASS_BUDGET, PLAN_GROUP, WAVE_CAP_ROWS, _schedule_passes, _waves,
    )
    from obj2voxel_tpu_torch.ops.plan import plan_mesh
    from obj2voxel_tpu_torch.ops.plan_device import plan_mesh_device

    z_extent = z_extent or stride
    order, segs = plan_mesh_device(table, aabb[0].shape[0], stride, z_extent,
                                   4 * MAX_PASS_BUDGET, group=PLAN_GROUP)
    if order is None:  # past the device planner's slabs, as stream_slabs does
        _, segs = plan_mesh(aabb[0], aabb[1], stride, z_extent, 4 * MAX_PASS_BUDGET)
    slabs = {}
    for seg in segs:
        slabs.setdefault((seg.z_lo, seg.z_hi), []).append(seg)
    passes = [p for ss in slabs.values() for p in _schedule_passes(ss, MAX_PASS_BUDGET)]
    budgets = Counter(p[1] for p in passes)
    text = (f"{len(slabs)} slabs, {len(passes)} passes, "
            f"{sum(b * n for b, n in budgets.items())} slots; by budget "
            f"{dict(sorted(budgets.items()))}")
    for cap in (1, 8):
        waves = list(_waves(list(slabs.items()), stride, MAX_PASS_BUDGET,
                            WAVE_CAP_ROWS, cap))
        launches = [len(items) for _, ds in waves for *_, items in ds]
        sizes = Counter(n for n in launches if n > 1)
        text += (f"; O2V_BATCH={cap}: {len(waves)} waves, {len(launches)} "
                 f"dispatches ({launches.count(1)} single), "
                 f"{sum(n for n in launches if n > 1)} batched, batched launches "
                 f"by size {dict(sorted(sizes.items()))}")
    return text


def batch_table():
    """Phase 17's stacked table and host AABBs, as `voxelize_batch` builds
    them (on the CPU), and its z extent."""
    import obj2voxel_tpu_torch as pt
    from obj2voxel_tpu_torch.engine import host_table, prepare_soup

    meshes = cs.batch_meshes()
    parts = []
    for i, tris in enumerate(meshes):
        verts, *rest = prepare_soup(pt.TriangleSoup.from_vertices(tris), cs.BATCH_RES)
        verts = verts.copy()
        verts[:, :, 2] += np.float32(i * cs.BATCH_RES)
        parts.append((verts, *rest))
    z_extent = len(meshes) * cs.BATCH_RES
    table, aabb = host_table(*(np.concatenate(c) for c in zip(*parts)),
                             stride=cs.BATCH_RES, z_extent=z_extent)
    return torch.from_numpy(table), aabb, z_extent


def schedules():
    """The pass schedule of the three paths that batch, computed on the CPU:
    the sphere at 1024^3, its table at 2048^3 (supersampled) and phase
    17's batch."""
    for name, res in (("untextured", cs.SPHERE_RES), ("supersampled", 2 * cs.SPHERE_RES)):
        table_np, aabb = cs.sphere_table(cs.SPHERE_TRIS, res)
        print(f"[schedule {name}] {pass_schedule(torch.from_numpy(table_np), aabb, res)}",
              flush=True)
    table, aabb, z_extent = batch_table()
    print(f"[schedule batch] {pass_schedule(table, aabb, cs.BATCH_RES, z_extent)}",
          flush=True)


def profile(name, table, pool, aabb, is_blend, top, **kw):
    (voxels, _), prof, wall, busy = traced(lambda: cs.drive_sphere(
        table, pool, aabb, is_blend, lambda xyz, argb: argb.view(torch.int32).sum(),
        **kw))
    print(f"[{name}] {voxels} voxels; profiled wall {wall:.2f} ms; device busy "
          f"{busy:.2f} ms; idle {100 * (1 - busy / wall):.1f}%", flush=True)
    by_kernel(prof, top)


def profile_calls(name, fn, top, calls=10):
    """`calls` back-to-back calls of one kernel's wrapper: the host time to
    enqueue a call (no profiler, no synchronize inside), then the device
    time of each of its launches beside the profiled wall time."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t) * 1e3 / calls
    torch.cuda.synchronize()
    _, prof, wall, busy = traced(lambda: [fn() for _ in range(calls)])
    print(f"[{name}] {calls} calls; host enqueue {host:.4f} ms a call; profiled "
          f"wall {wall / calls:.4f} ms a call; device busy {busy / calls:.4f} ms a "
          f"call", flush=True)
    by_kernel(prof, top)


def k5_input():
    """Phase 10's timing input: STREAM rows, a quarter live."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 30, cs.STREAM).astype(np.int32)
    keys[rng.random(cs.STREAM) >= 0.25] = cs.INV
    vals = tuple(torch.from_numpy(rng.random(cs.STREAM, dtype=np.float32)).cuda()
                 for _ in range(4))
    return torch.from_numpy(keys).cuda(), vals


def k1_input(table, aabb):
    """Phase 2's timing input: the middle 2^21-slot pass of the plan-ordered
    sphere table at expand 8, as fused_pass's arguments."""
    ordered, r0, z_lo, z_hi = cs.sphere_pass(table, aabb, lambda n: n // 2)
    n_rows = min(cs.BUDGET // 8, ordered.shape[0] - r0)
    return ((ordered, r0, n_rows, 0, z_lo, z_hi, cs.SPHERE_RES),
            dict(expand=8, budget=cs.BUDGET, wide_local=False))


def profile_combine(table, aabb, top):
    """The slab merge's combine on phase 3's `runs` stream and on the sphere
    slab's real merge input (the key-sorted slab with the most passes):
    CUDA-event ms and a trace of ten calls each of the engine's
    `_combine_presorted`, K2 alone, K3 alone on K2's output, and
    `combine_pack` alone (absent before it existed, so the same script
    measures a parent tree too)."""
    from obj2voxel_tpu_torch.engine import _combine_presorted
    from obj2voxel_tpu_torch.ops import combine_pallas
    from obj2voxel_tpu_torch.ops.combine import sort_channels
    from obj2voxel_tpu_torch.ops.pack_pallas import pack_exact

    _, keys, chans = next(cs.k2_inputs())
    streams = {"phase 3 runs": (keys, chans),
               "sphere slab merge": sort_channels(*cs.sphere_slab_runs(table, aabb)[:2])}
    fused = getattr(combine_pallas, "combine_pack", None)
    for what, (keys, chans) in streams.items():
        tk, *tv = combine_pallas.segment_combine(keys, *chans, True)
        calls = {
            "_combine_presorted": lambda: _combine_presorted(keys, chans, True),
            "K2 segment_combine": lambda: combine_pallas.segment_combine(
                keys, *chans, True),
            "K3 pack_exact on K2's output": lambda: pack_exact(tk, tuple(tv)),
        }
        if fused is not None:
            calls["combine_pack"] = lambda: fused(keys, chans, True)
        for name, fn in calls.items():
            label = f"{what} ({keys.numel()} rows, BLEND): {name}"
            print(f"[{label}] CUDA events {cs.cuda_ms(fn):.4f} ms a call (mean of "
                  f"10)", flush=True)
            profile_calls(label, fn, top)


def profile_batch(top):
    """One warm `voxelize_batch` of chip_smoke.py phase 17's batch: the
    trace (device busy, idle share, kernels), then one more run under
    cProfile for the host functions by cumulative time."""
    import cProfile
    import pstats

    import obj2voxel_tpu_torch as pt

    soups = [pt.TriangleSoup.from_vertices(t) for t in cs.batch_meshes()]

    def run():
        return pt.voxelize_batch(soups, resolution=cs.BATCH_RES)

    results, prof, wall, busy = traced(run)
    print(f"[batch] {len(soups)} meshes, {sum(x.shape[0] for x, _ in results)} "
          f"voxels; profiled wall {wall:.2f} ms; device busy {busy:.2f} ms; idle "
          f"{100 * (1 - busy / wall):.1f}%", flush=True)
    by_kernel(prof, top)
    host = cProfile.Profile()
    host.runcall(run)
    print("[batch] host functions by cumulative time (cProfile, one run):", flush=True)
    pstats.Stats(host, stream=sys.stdout).sort_stats("cumulative").print_stats(top)


PATHS = ("untextured", "merge-runs", "supersampled", "textured", "k1", "k4",
         "k5", "k6", "combine", "batch", "schedule", "sphere10m")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--paths", default=",".join(PATHS),
                    help=f"comma-separated subset of {','.join(PATHS)}")
    args = ap.parse_args()
    top, paths = args.top, args.paths.split(",")
    if not set(paths) <= set(PATHS):
        raise SystemExit(f"--paths: choose from {','.join(PATHS)}")
    if paths == ["schedule"]:
        schedules()  # host work only: runs without a card
        return
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs only on a GPU")
    import obj2voxel_tpu_torch as pt
    from obj2voxel_tpu_torch.ops.color import upload_pool

    print(f"[gpu] {cs.gpu_info()}", flush=True)
    table_np, aabb = cs.sphere_table(cs.SPHERE_TRIS, cs.SPHERE_RES)
    table = pt.table_from_numpy(table_np, "cuda")
    if "k1" in paths or "k4" in paths:
        tex_np, tex_aabb = cs.sphere_table(cs.SPHERE_TRIS, cs.SPHERE_RES,
                                           textured=True)
        tex_args, kw = k1_input(torch.from_numpy(tex_np).cuda(), tex_aabb)
    if "k1" in paths:
        from obj2voxel_tpu_torch.ops.pass_fused import fused_pass

        args, kw = k1_input(table, aabb)
        profile_calls("K1 fused_pass, 2^21 slots at expand 8",
                      lambda: fused_pass(*args, **kw), top)
        profile_calls("K1 fused_pass textured, the same pass of the textured table",
                      lambda: fused_pass(*tex_args, textured=True, **kw), top)
    if "k4" in paths:
        from obj2voxel_tpu_torch.ops.clip_pallas import clip_pairs, pass_pairs

        tri, vox, *_ = pass_pairs(tex_args[0].T.contiguous(), *tex_args[1:], **kw)
        profile_calls("K4 clip_pairs, the same pass's 2^21 pairs, textured",
                      lambda: clip_pairs(tri, vox), top)
    if "k5" in paths:
        from obj2voxel_tpu_torch.ops.pack_pallas import pack_channels

        keys, vals = k5_input()
        profile_calls("K5 pack_channels, 2^22 rows, a quarter live",
                      lambda: pack_channels(keys, vals), top)
    if "k6" in paths:
        from obj2voxel_tpu_torch.ops.merge_pallas import merge_runs

        keys, chans, offsets = cs.sphere_slab_runs(table, aabb)
        profile_calls(f"K6 merge_runs, sphere slab ({len(offsets) - 1} runs, "
                      f"{keys.numel()} rows)", lambda: merge_runs(keys, chans, offsets),
                      top)
    if "combine" in paths:
        profile_combine(table, aabb, top)
    if "untextured" in paths:
        print(f"[schedule] {pass_schedule(table, aabb, cs.SPHERE_RES)}", flush=True)
        profile("untextured BLEND", table, None, aabb, True, top)
    if "merge-runs" in paths:
        profile("merge-runs BLEND", table, None, aabb, True, top, merge_runs=True)
    if "supersampled" in paths:
        table_np, aabb = cs.sphere_table(cs.SPHERE_TRIS, 2 * cs.SPHERE_RES)
        profile("supersampled MAX", pt.table_from_numpy(table_np, "cuda"), None,
                aabb, False, top, stride=2 * cs.SPHERE_RES, do_down=True)
    if "batch" in paths:
        profile_batch(top)
    if "schedule" in paths:
        schedules()
    if "sphere10m" in paths:
        from obj2voxel_tpu_torch import bench

        del table
        table, aabb, _ = bench.upload_sphere(cs.SPHERE_10M_TRIS, cs.SPHERE_RES, "cuda")
        print(f"[schedule sphere10m] {pass_schedule(table, aabb, cs.SPHERE_RES)}",
              flush=True)
        profile("sphere10m BLEND", table, None, aabb, True, top)
    if "textured" in paths:
        table_np, aabb = cs.sphere_table(cs.SPHERE_TRIS, cs.SPHERE_RES, textured=True)
        pool, _ = cs.palette_pool()
        profile("textured MAX", pt.table_from_numpy(table_np, "cuda"),
                upload_pool(pool, "cuda"), aabb, False, top)


if __name__ == "__main__":
    main()
