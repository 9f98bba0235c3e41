"""Peak host memory of the port's binary STL reader, on both of its paths.

    python3 scripts/stl_loader_rss_torch.py [--tris 10000000] [--dir D]

Writes bench.py's sphere of ~N triangles (default 10M: 500 MB, config 4's
file) as a binary STL, builds the native mesh parser
(native/src/meshparse.cpp, with the system's C++ compiler) into the same
temporary directory, and loads the file with
`obj2voxel_tpu_torch.io.stl_loader.load_stl` once in a fresh process per
path: `numpy` (O2V_NO_NATIVE=1, the chunked reader) and `native`
(O2V_NATIVE_LIB, the parser over the file's bytes).  Prints one JSON line a
path: the seconds of the load, the resident set before it, its peak during
the load (`scale.PeakRss`, sampled every 10 ms, and the process's
ru_maxrss) and the rise, all in GB (1e9 B), with the file's and the
vertices' sizes and the vertices' sha256, which both paths must share.
Runs on the CPU only; needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import hashlib, json, resource, sys, time
from obj2voxel_tpu_torch.io.stl_loader import load_stl
from obj2voxel_tpu_torch.io.native import get_lib
from obj2voxel_tpu_torch.scale import PeakRss
native = get_lib() is not None
with PeakRss() as rss:
    t0 = time.perf_counter()
    soup = load_stl(sys.argv[1])
    seconds = time.perf_counter() - t0
maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
print(json.dumps({
    "native": native, "triangles": len(soup), "load_s": round(seconds, 3),
    "rss_start_gb": round(rss.start_gb, 3), "peak_rss_gb": round(rss.gb, 3),
    "ru_maxrss_gb": round(maxrss, 3), "rise_gb": round(rss.gb - rss.start_gb, 3),
    "verts_gb": round(soup.verts.nbytes / 1e9, 3),
    "verts_sha256": hashlib.sha256(soup.verts.tobytes()).hexdigest()}))
"""


def build_native(directory: str) -> str:
    lib = os.path.join(directory, "libo2vmesh.so")
    subprocess.run(["c++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", lib,
                    os.path.join(REPO, "native", "src", "meshparse.cpp")], check=True)
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tris", type=int, default=10_000_000)
    ap.add_argument("--dir", default=None, help="write the STL and the library here")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from obj2voxel_tpu_torch.utils.meshes import make_sphere_mesh, write_stl

    with tempfile.TemporaryDirectory(prefix="o2v_stl_rss_") as tmp:
        directory = args.dir or tmp
        stl = os.path.join(directory, "sphere.stl")
        tris = make_sphere_mesh(args.tris)
        write_stl(stl, tris)
        del tris
        lib = build_native(directory)
        digests = set()
        for path, extra in (("numpy", {"O2V_NO_NATIVE": "1"}),
                            ("native", {"O2V_NATIVE_LIB": lib})):
            env = {**os.environ, **extra, "PYTHONPATH": REPO}
            out = subprocess.run([sys.executable, "-c", CHILD, stl], env=env,
                                 check=True, capture_output=True, text=True).stdout
            result = json.loads(out.strip().splitlines()[-1])
            if result["native"] != (path == "native"):
                raise SystemExit(f"{path}: the loader took the other path: {result}")
            digests.add(result.pop("verts_sha256"))
            print(json.dumps({"path": path, "file_gb": round(os.path.getsize(stl) / 1e9, 3),
                              **result}), flush=True)
        if len(digests) != 1:
            raise SystemExit("the two paths read different vertices")


if __name__ == "__main__":
    main()
