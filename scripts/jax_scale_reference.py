"""The JAX package's `Instance` on reduced BASELINE configs 4 and 6, as a
fixture for tests/test_torch_scale.py.

  config4  an STL at 2048^3: eight small UV spheres (bench.py's mesh, 200
           to 900 triangles each, radius 0.018) at the corners of the cube
           [-1, 1]^3, so the voxels reach both ends of every axis (x + r y
           keys near r^2, slabs at both ends of z) while the count stays
           small; config 4 itself is a 10M-triangle sphere
  config6  an STL at 8192^3: a quarter turn of scripts/scale_proof.py's
           helix tube, 40k triangles, tube radius 2.5e-5, its z flattened
           to 6%: the quarter turn's 0.45 x/y extent spans the grid, z
           some 1090 layers, cut into 37 slabs of at most 30 layers (keys
           below 2^31), so the host planner plans it, as it plans config 6
           (100k triangles, three turns, radius 0.002, 274 slabs).  The
           tube is under half a voxel thick and its triangles about two
           voxels long: thin diagonal slivers would cost the clip their
           whole bounding boxes

The meshes and the STL bytes come from bench.py and scripts/scale_proof.py
themselves.  Each STL goes through the JAX package's `Instance` into VL32 (MAX, the
default) on the CPU, op by op (`jax.disable_jit()`: no multiply-add
contraction, like the port).  That takes minutes, far past what a test may
spend, so tests/fixtures/jax_scale.npz keeps, a config: the sha256 of the
STL bytes it came from, the resolution, the voxel count, the sha256 of the
VL32 bytes and the bytes themselves.  The reference is frozen, so the
fixture stays valid until the meshes change.

    JAX_PLATFORMS=cpu python3 scripts/jax_scale_reference.py

Prints one line a config: its voxels, its VL32 sha256 and its seconds.
"""

from __future__ import annotations

import hashlib
import io
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
OUT = REPO / "tests" / "fixtures" / "jax_scale.npz"


def _scale_proof():
    """scripts/scale_proof.py as a module (it imports bench.py, no JAX)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "scale_proof", REPO / "scripts" / "scale_proof.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def config4_tris():
    """Eight small spheres at the corners of [-1, 1]^3 (N, 3, 3) float32."""
    from bench import make_sphere_mesh

    parts = []
    for i in range(8):
        corner = np.array([1.0 if i & (1 << a) else -1.0 for a in range(3)], np.float32)
        parts.append(make_sphere_mesh(200 + 100 * i) * np.float32(0.018) + corner)
    return np.concatenate(parts).astype(np.float32)


def config6_tris():
    """A quarter turn of the helix tube, 40k triangles, radius 2.5e-5, z
    scaled by 0.06 (N, 3, 3) float32."""
    tris = _scale_proof().make_helix_mesh(40_000, turns=0.25, tube_r=2.5e-5)
    tris[..., 2] *= np.float32(0.06)
    return tris


#: config -> (mesh builder, resolution)
CASES = {"config4": (config4_tris, 2048), "config6": (config6_tris, 8192)}


def stl_bytes(tris) -> bytes:
    """The binary STL of `tris`, as scripts/scale_proof.py writes it."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.stl")
        _scale_proof().write_stl(path, tris)
        return Path(path).read_bytes()


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import obj2voxel_tpu as pkg

    pkg.set_log_level(pkg.constants.LOG_LEVEL_SILENT)
    arrays = {}
    for case, (build, res) in CASES.items():
        data = stl_bytes(build())
        with tempfile.TemporaryDirectory() as tmp:
            stl = os.path.join(tmp, "mesh.stl")
            Path(stl).write_bytes(data)
            inst = pkg.Instance()
            inst.set_input_file(stl, "stl")
            inst.set_output_memory("vl32")
            inst.set_resolution(res)
            t = time.perf_counter()
            with jax.disable_jit():
                err = inst.voxelize()
            secs = time.perf_counter() - t
        if err != pkg.constants.ERR_OK:
            raise SystemExit(f"{case}: voxelize failed ({err})")
        vl32 = inst.get_output_memory()
        digest = hashlib.sha256(vl32).hexdigest()
        arrays[f"{case}_stl_sha256"] = np.array(hashlib.sha256(data).hexdigest())
        arrays[f"{case}_res"] = np.array(res)
        arrays[f"{case}_voxels"] = np.array(len(vl32) // 16)
        arrays[f"{case}_vl32_sha256"] = np.array(digest)
        arrays[f"{case}_vl32"] = np.frombuffer(vl32, np.uint8)
        print(f"{case}: {len(vl32) // 16} voxels at {res}^3, vl32 sha256 {digest}, "
              f"{secs:.1f} s", flush=True)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_bytes(buf.getvalue())
    print(f"wrote {OUT.relative_to(REPO)} ({OUT.stat().st_size} bytes)", flush=True)


if __name__ == "__main__":
    main()
