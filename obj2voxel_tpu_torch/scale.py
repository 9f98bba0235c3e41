"""Scale runs of BASELINE configs 4-6 on one CUDA device.

The counterpart of the repo's scripts/scale_proof.py:

  config 4: a 10M-triangle binary STL (bench.py's sphere) through
            `Instance` into a VL32 file at 2048^3, streamed slab by slab.
  config 5: 1000 small spheres (50-399 triangles, scaled 0.5-1.5) in one
            `voxelize_batch` stream at 64^3.
  config 6: a 100k-triangle helix tube spanning the grid through `Instance`
            into VL32 at 8192^3: ~270 z-slabs, past the device planner's
            32, so the host planner plans it; its memory must stay
            O(active voxels per slab), below config 4's.

    [O2V_TIMING=1] python3 -m obj2voxel_tpu_torch.scale [4|5|6|all]
                                                     [--device cpu] [--dir D]

Prints one JSON line a config with scale_proof.py's fields (config, desc,
exit, voxels, wall_s, peak_rss_gb) and this package's: peak_device_gib
(`torch.cuda.max_memory_allocated`, 0 on the CPU), the sha256 of the VL32
file, `engine.WAVE_STATS` (slabs, waves, passes, plan-order rows, which
planner) and, under O2V_TIMING=1, after the engine's `[o2v-timing]` lines,
`stage_s`: their host seconds by stage (`engine.TIMING_S`: load, prepare,
table, plan, passes, merges, pulls, write, and the rest of the wall time
as `other`).  peak_rss_gb is the peak resident set of the process during
the run, rss_start_gb the one before it (`PeakRss`).  Files go to a
temporary directory (or --dir) and are removed after the run unless --dir
is given.  The configs run on CUDA unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
import threading
import time

import numpy as np
import torch

from .api import Instance
from .constants import ERR_OK, LOG_LEVEL_SILENT
from .engine import TIMING_S, WAVE_STATS, voxelize_batch
from .soup import TriangleSoup
from .utils.log import log
from .utils.meshes import make_helix_mesh, make_sphere_mesh, write_stl

__all__ = ["CONFIGS", "PeakRss", "config4", "config5", "config6",
           "file_sha256", "voxelize_file", "main"]

#: (config, triangles, resolution) of configs 4 and 6 (scripts/scale_proof.py)
CONFIGS = {4: (10_000_000, 2048), 6: (100_000, 8192)}


def _rss_gb() -> float:
    """The process's current resident set, in GB."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


class PeakRss:
    """Peak resident set of the process over a `with` block, in GB (1e9 B,
    as scale_proof.py's rss_gb), and `start_gb`, the resident set on entry.
    A thread samples the RSS every 10 ms (a spike shorter than that can be
    missed): ru_maxrss is the process's peak so far, and Linux lets a
    process reset its peak only where /proc/self/clear_refs is writable."""

    def __enter__(self):
        self.start_gb = self.gb = _rss_gb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while True:
            self.gb = max(self.gb, _rss_gb())
            if self._stop.wait(0.01):
                return

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.gb = max(self.gb, _rss_gb())
        return False


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def voxelize_file(stl: str, out: str, resolution: int, device="cuda") -> dict:
    """One `Instance` run of a binary STL into a VL32 file at `resolution`
    (MAX, the default strategy): exit code, voxels, the file's sha256, wall
    seconds, peak RSS and device memory, WAVE_STATS and (under
    O2V_TIMING=1) host seconds by stage."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    TIMING_S.clear()
    with PeakRss() as rss:
        t0 = time.perf_counter()
        inst = Instance(device)
        inst.set_input_file(stl, "stl")
        inst.set_output_file(out, "vl32")
        inst.set_resolution(resolution)
        code = inst.voxelize()
        wall = time.perf_counter() - t0
    result = {
        "exit": code,
        "voxels": os.path.getsize(out) // 16,
        "vl32_sha256": file_sha256(out),
        "wall_s": round(wall, 3),
        "peak_rss_gb": round(rss.gb, 3),
        "rss_start_gb": round(rss.start_gb, 3),
        "peak_device_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)
        if cuda else 0.0,
        "wave_stats": dict(WAVE_STATS),
    }
    if os.environ.get("O2V_TIMING") == "1":
        secs = dict(TIMING_S, other=wall - sum(TIMING_S.values()))
        result["stage_s"] = {k: round(v, 3) for k, v in secs.items()}
    return result


def _stl_config(config, desc, make, directory, resolution, device, keep):
    stl = os.path.join(directory, f"o2v_scale_{config}.stl")
    out = os.path.join(directory, f"o2v_scale_{config}.vl32")
    t0 = time.perf_counter()
    tris = make()
    write_stl(stl, tris)
    n = tris.shape[0]
    del tris
    made = time.perf_counter() - t0
    try:
        result = voxelize_file(stl, out, resolution, device)
    finally:
        if not keep:
            for path in (stl, out):
                if os.path.exists(path):
                    os.remove(path)
    return {"config": config, "desc": desc, "triangles": n, "resolution": resolution,
            "stl_s": round(made, 3), **result}


def config4(directory, n_tris=CONFIGS[4][0], resolution=CONFIGS[4][1],
            device="cuda", keep=False):
    """bench.py's sphere of ~n_tris triangles as a binary STL through
    `Instance` into VL32 at resolution^3."""
    return _stl_config(
        4, f"{n_tris / 1e6:g}M-tri STL -> {resolution}^3 VL32 (streamed slabs)",
        lambda: make_sphere_mesh(n_tris), directory, resolution, device, keep)


def config5(device="cuda"):
    """1000 small spheres through `voxelize_batch` at 64^3 (MAX)."""
    rng = np.random.RandomState(0)
    soups = []
    for _ in range(1000):
        n = int(rng.randint(50, 400))
        soups.append(TriangleSoup.from_vertices(make_sphere_mesh(n) * rng.uniform(0.5, 1.5)))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with PeakRss() as rss:
        t0 = time.perf_counter()
        results = voxelize_batch(soups, resolution=64, device=device)
        wall = time.perf_counter() - t0
    return {
        "config": 5, "desc": "1000 small meshes batched at 64^3",
        "meshes": len(results),
        "nonempty": sum(1 for x, _ in results if x.shape[0]),
        "voxels": sum(x.shape[0] for x, _ in results),
        "wall_s": round(wall, 3), "meshes_per_s": round(len(results) / wall, 1),
        "peak_rss_gb": round(rss.gb, 3), "rss_start_gb": round(rss.start_gb, 3),
        "peak_device_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)
        if cuda else 0.0,
    }


def config6(directory, n_tris=CONFIGS[6][0], resolution=CONFIGS[6][1],
            device="cuda", keep=False):
    """A helix tube of ~n_tris triangles as a binary STL through `Instance`
    into VL32 at resolution^3."""
    return _stl_config(
        6, f"{n_tris / 1e3:g}k-tri helix -> {resolution}^3 VL32 (streamed slabs, "
        f"host planner)", lambda: make_helix_mesh(n_tris), directory, resolution,
        device, keep)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all", choices=("4", "5", "6", "all"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dir", default=None, help="keep the STL and VL32 files here")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("obj2voxel_tpu_torch.scale: no CUDA device")
    which = (4, 5, 6) if args.which == "all" else (int(args.which),)
    level = log.get_level()
    log.set_level(LOG_LEVEL_SILENT)
    try:
        with tempfile.TemporaryDirectory(prefix="o2v_scale_") as tmp:
            directory = args.dir or tmp
            os.makedirs(directory, exist_ok=True)
            for config in which:
                if config == 5:
                    result = config5(args.device)
                else:
                    fn = config4 if config == 4 else config6
                    result = fn(directory, *CONFIGS[config], args.device,
                                keep=args.dir is not None)
                print(json.dumps(result), flush=True)
                if result.get("exit", ERR_OK) != ERR_OK or not result["voxels"]:
                    raise SystemExit(f"config {config} failed: {result}")
    finally:
        log.set_level(level)

if __name__ == "__main__":
    main()
