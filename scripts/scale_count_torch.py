"""The port's CPU runs behind chip_smoke.py's constants for phases 21-23.

Each case runs the port (obj2voxel_tpu_torch) on the CPU and prints one
JSON line: its voxel count, its digest, the seconds it took and the
process's peak RSS.

  sphere10m  bench.py's 10M-triangle sphere table at 1024^3 BLEND (the
             bench entry's device mode): voxels and `bench.occupancy_sha256`
             (the sorted voxel set; BLEND colors are not digested)
  host2m     the bench entry's host mode: the 2M-triangle sphere as a
             TriangleSoup through `voxelize_soup` at 1024^3 BLEND: voxels and
             the occupancy digest
  config4    BASELINE config 4: the 10M-triangle sphere as a binary STL
             through `Instance` into VL32 at 2048^3 (MAX): voxels and the
             file's sha256
  config6    BASELINE config 6: the 100k-triangle helix as a binary STL
             through `Instance` into VL32 at 8192^3: voxels, the file's
             sha256 and WAVE_STATS (slabs, host planner)

    python3 scripts/scale_count_torch.py [--cases sphere10m,host2m,config4,config6]
                                         [--dir D] [--threads T]

The runs plan on the host (O2V_HOST_PLAN=1) and cap a wave at 2^23 pair
slots (O2V_WAVE_CAP), which bounds host memory on the CPU (the device
planner's (triangles x slabs) key matrix at 10M triangles takes several
GB there).  Neither moves a voxel: the occupancy digests cover the voxel
set only, and the two STL configs have one color (STL carries none) and
write their slabs in z order, keys z-major within a slab, so their bytes
are the sorted voxel set whatever the slab edges.  Files go to --dir (else
a temporary directory) and are removed after each run.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CASES = ("sphere10m", "host2m", "config4", "config6")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--dir", default=None)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    os.environ["O2V_HOST_PLAN"] = "1"
    os.environ["O2V_WAVE_CAP"] = str(1 << 23)

    import torch

    from obj2voxel_tpu_torch import bench, scale
    from obj2voxel_tpu_torch.constants import BLEND_STRATEGY, LOG_LEVEL_SILENT
    from obj2voxel_tpu_torch.engine import voxelize_soup
    from obj2voxel_tpu_torch.soup import TriangleSoup
    from obj2voxel_tpu_torch.utils.log import log
    from obj2voxel_tpu_torch.utils.meshes import make_sphere_mesh

    torch.set_num_threads(args.threads)
    log.set_level(LOG_LEVEL_SILENT)
    with tempfile.TemporaryDirectory(prefix="o2v_count_", dir=args.dir) as tmp:
        for case in args.cases.split(","):
            t = time.perf_counter()
            if case == "sphere10m":
                sphere = bench.upload_sphere(10_000_000, 1024, "cpu")
                voxels, digest = bench.sphere_occupancy(sphere, 1024)
                del sphere
                out = {"voxels": voxels, "occupancy_sha256": digest}
            elif case == "host2m":
                soup = TriangleSoup.from_vertices(make_sphere_mesh(2_000_000))
                voxels, digest = bench.occupancy_sha256(
                    (xyz for xyz, _ in voxelize_soup(
                        soup, resolution=1024, strategy=BLEND_STRATEGY,
                        device="cpu")), 1024)
                del soup
                out = {"voxels": voxels, "occupancy_sha256": digest}
            elif case in ("config4", "config6"):
                fn = scale.config4 if case == "config4" else scale.config6
                r = fn(tmp, device="cpu")
                out = {k: r[k] for k in ("voxels", "vl32_sha256", "exit",
                                         "wave_stats", "triangles", "resolution")}
            else:
                raise SystemExit(f"unknown case {case}")
            print(json.dumps({
                "case": case, **out, "seconds": round(time.perf_counter() - t, 1),
                "peak_rss_gb_process": round(
                    resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2),
                "threads": args.threads}), flush=True)


if __name__ == "__main__":
    main()
