"""Benchmark: voxelization throughput of the port on one CUDA device.

The counterpart of the repo's bench.py, with its arguments, defaults and
output: one JSON line {"metric", "value", "unit", "vs_baseline"}, where
value is Mtriangles/s at RES^3 BLEND and vs_baseline the voxel throughput
over the reference's 10 Mvox/s claim (reference README.adoc:266-270).

    python3 -m obj2voxel_tpu_torch.bench [N] [RES] [device|pull|host]

The mesh is bench.py's UV sphere of ~N triangles (default 2,000,000) at
RES^3 (default 1024).  Modes:
  device (default): the table is built in voxel space on the host, as
                    bench.py builds it, and uploaded once; each run streams
                    `stream_slabs(device_outputs=True)`, keeps the outputs
                    on the device and folds every output byte into a
                    checksum on the device, read back once at the end.
  pull:             the same run, each slab's voxels copied to the host.
  host:             `voxelize_soup` of a TriangleSoup: transform,
                    subdivision, table, upload and the stream.
Each mode runs once warm, then 3 timed runs, each ending in
`torch.cuda.synchronize()`; every run must give the warm run's voxel count,
and the median is reported.  `main` runs on CUDA and fails when no card is
present; the functions take `device=` (the tests pass "cpu").
"""

from __future__ import annotations

import hashlib
import json
import sys
import time

import numpy as np
import torch

from .constants import ANTI_BLEED, BLEND_STRATEGY, TRI_MATERIALLESS, TRI_TEXTURED
from .engine import MAX_PASS_BUDGET, stream_slabs, voxelize_soup
from .soup import TriangleSoup, build_tri_table, pow2_at_least
from .utils.meshes import make_sphere_mesh

__all__ = ["MODES", "occupancy_sha256", "result_line", "run_device_resident",
           "run_host", "run_mode", "sphere_occupancy", "sphere_table", "timed",
           "upload_sphere", "main"]

MODES = ("device", "pull", "host")


def sphere_table(n_target: int, resolution: int, textured: bool = False):
    """bench.py's device-mode input: the sphere scaled into voxel space as
    the engine's transform would, padded to a power of two (materialless
    white rows), as a host (N_pad, 24) table, its host voxel AABBs and its
    triangle count.  With textured=True the UV columns hold per-vertex
    spherical UVs and every row is TRI_TEXTURED with texture 0; the
    geometry is unchanged."""
    tris, uvs = (make_sphere_mesh(n_target, uvs=True) if textured
                 else (make_sphere_mesh(n_target), None))
    n = tris.shape[0]
    scale = (resolution - ANTI_BLEED) / 2.0
    tris = (tris + 1.0) * np.float32(scale) + np.float32(ANTI_BLEED / 2.0)
    n_pad = pow2_at_least(n)
    verts = np.zeros((n_pad, 3, 3), np.float32)
    verts[:n] = tris
    uv_pad = np.zeros((n_pad, 3, 2), np.float32)
    if textured:
        uv_pad[:n] = uvs
        types, tex = np.full(n_pad, TRI_TEXTURED, np.int32), np.zeros(n_pad, np.int32)
    else:
        types = np.full(n_pad, TRI_MATERIALLESS, np.int32)
        tex = np.full(n_pad, -1, np.int32)
    table = build_tri_table(verts, uv_pad, types, np.ones((n_pad, 3), np.float32), tex)
    vmin = np.clip(np.floor(tris.min(axis=1)), 0, resolution).astype(np.int64)
    vmax = np.clip(np.floor(tris.max(axis=1)) + 1, 0, resolution).astype(np.int64)
    return table, (vmin, vmax), n


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(run, device, reps=3):
    """One warm run, then `reps` timed runs of `run` (which returns the
    voxel count), each ending in a synchronize and each asserted to give
    the warm run's count.  Returns (voxels, host seconds of each run)."""
    voxels = run()
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        got = run()
        _sync(device)
        times.append(time.perf_counter() - t0)
        assert got == voxels, f"voxel count changed between runs: {got} != {voxels}"
    return voxels, times


def upload_sphere(n_target: int, resolution: int, device="cuda"):
    """`sphere_table` on `device`: (table, host AABBs, triangles)."""
    table_np, aabb, n = sphere_table(n_target, resolution)
    return torch.from_numpy(table_np).to(torch.device(device)), aabb, n


def _stream(sphere, resolution, device_outputs):
    table, aabb, _ = sphere
    return stream_slabs(table, None, aabb_host=aabb, stride=resolution,
                        z_extent=resolution, is_blend=True,
                        pair_tile=MAX_PASS_BUDGET, device_outputs=device_outputs)


def run_device_resident(n_target: int, resolution: int, pull: bool = False,
                        device="cuda", sphere=None):
    """device / pull mode; returns (triangles, voxels, run seconds).
    `sphere` is an `upload_sphere` result to reuse."""
    device = torch.device(device)
    if sphere is None:
        sphere = upload_sphere(n_target, resolution, device)

    def run():
        voxels = 0
        if pull:
            for xyz, _ in _stream(sphere, resolution, False):
                voxels += xyz.shape[0]
            return voxels
        check = torch.zeros((), dtype=torch.int64, device=device)
        for xyz, argb, count in _stream(sphere, resolution, True):
            voxels += count
            # touch every output byte on the device (proves materialization)
            check += argb[:count].view(torch.int32).sum(dtype=torch.int64)
            check += xyz[:count].sum(dtype=torch.int64)
        check.item()
        return voxels

    voxels, times = timed(run, device)
    return sphere[2], voxels, times


def occupancy_sha256(xyz_batches, resolution: int) -> tuple[int, str]:
    """(voxels, sha256 of the occupied voxels' (x, y, z) as little-endian
    int32, sorted by z, then y, then x): a digest of the voxel set alone,
    whatever the planner, the route or the colors."""
    xyz = np.concatenate(list(xyz_batches) or [np.zeros((0, 3), np.int32)])
    key = (xyz[:, 2].astype(np.int64) * resolution + xyz[:, 1]) * resolution + xyz[:, 0]
    xyz = xyz[np.argsort(key, kind="stable")]
    return xyz.shape[0], hashlib.sha256(np.ascontiguousarray(xyz, "<i4").tobytes()).hexdigest()


def sphere_occupancy(sphere, resolution: int) -> tuple[int, str]:
    """One device-mode stream of an `upload_sphere` table, its voxels pulled:
    `occupancy_sha256` of its output."""
    return occupancy_sha256((xyz for xyz, _ in _stream(sphere, resolution, False)),
                            resolution)


def run_host(n_target: int, resolution: int, device="cuda"):
    """host mode; returns (triangles, voxels, run seconds)."""
    device = torch.device(device)
    soup = TriangleSoup.from_vertices(make_sphere_mesh(n_target))

    def run():
        return sum(xyz.shape[0] for xyz, _ in voxelize_soup(
            soup, resolution=resolution, strategy=BLEND_STRATEGY, device=device))

    voxels, times = timed(run, device)
    return len(soup), voxels, times


def run_mode(n_target: int, resolution: int, mode: str, device="cuda"):
    """(triangles, voxels, run seconds) of one mode."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if mode == "host":
        return run_host(n_target, resolution, device)
    return run_device_resident(n_target, resolution, pull=mode == "pull",
                               device=device)


def result_line(n: int, voxels: int, elapsed: float, resolution: int, mode: str):
    """bench.py's JSON object for one mode's median run."""
    return {
        "metric": (f"Mtriangles/s @ {resolution}^3 blend "
                   f"({n} tris, {voxels} voxels, {elapsed:.3f}s, {mode}-resident)"),
        "value": round(n / elapsed / 1e6, 3),
        "unit": "Mtri/s",
        "vs_baseline": round(voxels / elapsed / 1e6 / 10.0, 3),
    }


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n_target = int(argv[0]) if len(argv) > 0 else 2_000_000
    resolution = int(argv[1]) if len(argv) > 1 else 1024
    mode = argv[2] if len(argv) > 2 else "device"
    if not torch.cuda.is_available():
        raise SystemExit("obj2voxel_tpu_torch.bench: no CUDA device")
    n, voxels, times = run_mode(n_target, resolution, mode, "cuda")
    print(json.dumps(result_line(n, voxels, sorted(times)[len(times) // 2],
                                 resolution, mode)),
          flush=True)


if __name__ == "__main__":
    main()
