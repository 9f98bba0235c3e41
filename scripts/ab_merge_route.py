"""The merge-runs route against the default route on chip_smoke.py's
2M-triangle sphere at 1024^3 BLEND, timed in turns on one CUDA card, in the
checkout it is run from.

    cd <checkout> && python3 <this checkout>/scripts/ab_merge_route.py [--pairs 3]

It imports `chip_smoke` and the package from the current directory, so the
same script times an older checkout too: to compare two commits, unpack the
other one with `git archive` and run the script from each checkout in
turns (other, this, this, other) within one call on one card.  Prints the
host-clock seconds of every run of each route (each ends in a synchronize),
their medians and the ratio, and the allocator's device allocations and
frees during one warm run of each route.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=3,
                    help="rounds of (default, merge-runs, merge-runs, default)")
    pairs = ap.parse_args().pairs
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this A/B runs only on a GPU")
    import obj2voxel_tpu_torch as pt

    table_np, aabb = cs.sphere_table(cs.SPHERE_TRIS, cs.SPHERE_RES)
    table = pt.table_from_numpy(table_np, "cuda")

    def run(flag):
        return cs.drive_sphere(table, None, aabb, True, cs.touch, merge_runs=flag)

    want = run(False)
    if run(True) != want:
        raise SystemExit("the merge-runs route's output differs from the default's")
    keys = ("num_device_alloc", "num_device_free")
    for flag in (False, True):
        before = torch.cuda.memory_stats()
        run(flag)
        after = torch.cuda.memory_stats()
        print(f"  merge_runs={flag}: device allocations and frees in a warm run "
              f"{[after.get(k, 0) - before.get(k, 0) for k in keys]}", flush=True)
    times = {False: [], True: []}
    for flag in (False, True, True, False) * pairs:
        times[flag] += cs.timed_runs(lambda: run(flag), want, "merge-runs A/B", n=1)
    med = {flag: sorted(t)[len(t) // 2] for flag, t in times.items()}
    print(f"[{Path.cwd().name}] {cs.gpu_info()}: default {med[False]:.4f} s "
          f"{[round(x, 4) for x in times[False]]}; merge-runs {med[True]:.4f} s "
          f"{[round(x, 4) for x in times[True]]}; merge-runs / default "
          f"{med[True] / med[False]:.3f}", flush=True)


if __name__ == "__main__":
    main()
