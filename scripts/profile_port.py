"""Where the port's time goes on one CUDA card: a torch.profiler trace of one
warm `stream_slabs` run of chip_smoke.py's 2M-triangle sphere at 1024^3,
untextured (BLEND, K1 passes), textured (MAX, K4 passes with one 4096^2
REPEAT texture), untextured through the merge-runs route (BLEND, K6) and
supersampled from 2048^3 (MAX), outputs kept on the device.

    python3 scripts/profile_port.py [--top 15]

Prints, per path, the wall time of the profiled run, the device's busy time
(the union of its kernel intervals) and idle share, and the kernels with the
most device time.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

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


def profile(name, table, pool, aabb, is_blend, top, **kw):
    from torch.profiler import ProfilerActivity, profile as tprofile

    def run():
        return cs.drive_sphere(table, pool, aabb, is_blend,
                               lambda xyz, argb: argb.view(torch.int32).sum(), **kw)

    run()  # warm
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        voxels, _ = run()
        wall = (time.perf_counter() - t) * 1e3
    busy = busy_ms(prof.events())
    print(f"[{name}] {voxels} voxels; profiled wall {wall:.2f} ms; device busy "
          f"{busy:.2f} ms; idle {100 * (1 - busy / wall):.1f}%", flush=True)
    rows = [a for a in prof.key_averages() if a.device_time_total > 0]
    rows.sort(key=lambda a: a.device_time_total, reverse=True)
    for a in rows[:top]:
        print(f"  {a.device_time_total / 1e3:9.3f} ms  {a.count:5d}x  {a.key[:90]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=15)
    top = ap.parse_args().top
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs only on a GPU")
    import obj2voxel_tpu_torch as pt
    from obj2voxel_tpu_torch.ops.color import upload_pool

    print(f"[gpu] {cs.gpu_info()}", flush=True)
    table_np, aabb = cs.sphere_table(cs.SPHERE_TRIS, cs.SPHERE_RES)
    table = pt.table_from_numpy(table_np, "cuda")
    profile("untextured BLEND", table, None, aabb, True, top)
    profile("merge-runs BLEND", table, None, aabb, True, top, merge_runs=True)
    table_np, aabb = cs.sphere_table(cs.SPHERE_TRIS, 2 * cs.SPHERE_RES)
    profile("supersampled MAX", pt.table_from_numpy(table_np, "cuda"), None, aabb,
            False, top, stride=2 * cs.SPHERE_RES, do_down=True)
    table_np, aabb = cs.sphere_table(cs.SPHERE_TRIS, cs.SPHERE_RES, textured=True)
    pool, _ = cs.palette_pool()
    profile("textured MAX", pt.table_from_numpy(table_np, "cuda"),
            upload_pool(pool, "cuda"), aabb, False, top)


if __name__ == "__main__":
    main()
