"""The voxel count and digest of chip_smoke.py phase 17's batch, on the CPU.

Phase 17 sends BASELINE.md config 5 (1000 UV spheres of 50-400 triangles,
scaled by 0.5-1.5, from RandomState(0); scripts/scale_proof.py:104-115)
through `voxelize_batch` at 64^3 MAX on the card, and gates on the count
and the sha256 of the per-mesh outputs (`chip_smoke.batch_digest`).  This
script runs the same batch, or its first --meshes meshes, through either
package's `voxelize_batch` on the CPU: the JAX package op by op
(`jax.disable_jit()`: no multiply-add contraction, like the port) or the
port.

    python3 scripts/batch_count.py --package port
    python3 scripts/batch_count.py --package jax --meshes 100

Prints one JSON line: the package, the meshes, the voxel count, the
non-empty meshes, the sha256 and the seconds the run took.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--meshes", type=int, default=None,
                    help="the first N meshes of the batch (default: all)")
    args = ap.parse_args()
    if args.package == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        from obj2voxel_tpu.engine import TriangleSoup, voxelize_batch

        run, kw = jax.disable_jit, {}
    else:
        from obj2voxel_tpu_torch import TriangleSoup, voxelize_batch

        run, kw = contextlib.nullcontext, {"device": "cpu"}
    import chip_smoke as cs

    meshes = cs.batch_meshes()[: args.meshes]
    soups = [TriangleSoup.from_vertices(t) for t in meshes]
    t = time.perf_counter()
    with run():
        results = voxelize_batch(soups, resolution=cs.BATCH_RES, **kw)
    seconds = time.perf_counter() - t
    voxels, nonempty, digest = cs.batch_digest(results)
    print(json.dumps({"package": args.package, "meshes": len(soups),
                      "voxels": voxels, "nonempty": nonempty, "sha256": digest,
                      "seconds": seconds}), flush=True)


if __name__ == "__main__":
    main()
