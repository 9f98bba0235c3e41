"""The voxel count of chip_smoke.py phase 12's `Instance` run, on the CPU.

Phase 12 sends the textured 2M-triangle sphere (spherical UVs, one 4096^2
REPEAT texture of 64 palette colors) through `Instance.set_input_soup` at
1024^3 under MAX.  The host transform and subdivision build another table
than the phase's own, so its count is not the table path's 4,936,255.
This script runs the same soup through either package's `Instance` on the
CPU: the JAX package op by op (`jax.disable_jit()`: no multiply-add
contraction, like the port) or the port.

    python3 scripts/instance_sphere_count.py --package jax
    python3 scripts/instance_sphere_count.py --package port
    python3 scripts/instance_sphere_count.py --package jax --tris 2000 --res 64

Prints one JSON line: the package, the voxel count, the sha256 of the VL32
bytes and the seconds the run took.  Each run is single-process; the JAX
run takes tens of minutes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--tris", type=int, default=2_000_000)
    ap.add_argument("--res", type=int, default=1024)
    args = ap.parse_args()
    if args.package == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        import obj2voxel_tpu as pkg

        instance, run = pkg.Instance, jax.disable_jit
    else:
        import contextlib

        import obj2voxel_tpu_torch as pkg

        instance, run = (lambda: pkg.Instance("cpu")), contextlib.nullcontext
    import chip_smoke as cs
    from obj2voxel_tpu_torch.utils.meshes import make_sphere_mesh

    pkg.set_log_level(pkg.constants.LOG_LEVEL_SILENT)
    texels, _ = cs.palette_texels()
    pool = pkg.TexturePool()
    pool.add(texels, pkg.constants.UV_WRAP)
    tris, uvs = make_sphere_mesh(args.tris, uvs=True)
    n = tris.shape[0]
    soup = pkg.TriangleSoup(tris, uvs, np.full(n, pkg.constants.TRI_TEXTURED, np.int32),
                            np.ones((n, 3), np.float32), np.zeros(n, np.int32))
    inst = instance()
    inst.set_input_soup(soup, pool)
    inst.set_output_memory("vl32")
    inst.set_resolution(args.res)
    t = time.perf_counter()
    with run():
        err = inst.voxelize()
    seconds = time.perf_counter() - t
    if err != pkg.constants.ERR_OK:
        raise SystemExit(f"voxelize failed: {err}")
    data = inst.get_output_memory()
    print(json.dumps({"package": args.package, "tris": args.tris, "res": args.res,
                      "voxels": len(data) // 16,
                      "vl32_sha256": hashlib.sha256(data).hexdigest(),
                      "seconds": seconds}), flush=True)


if __name__ == "__main__":
    main()
