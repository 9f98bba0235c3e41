"""Build and load the hand-written Hopper kernels (csrc/*.cu).

The sources are compiled by `nvcc` into one shared library with a plain C
interface and loaded with ctypes: no PyTorch headers, so a build takes
seconds.  The library is keyed by a hash of the sources and flags and lives
in `build/o2v_kernels/` beside the package; it is built on first use, i.e.
when a CUDA tensor first reaches a kernel wrapper.  Importing this module
needs neither nvcc nor a card.

Every C launcher returns its `cudaGetLastError()`; `check` raises on any
non-zero code, so a refused launch never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "o2v_kernels"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *ARCH_FLAGS, "-O3", "--fmad=false", "-std=c++17", "-lineinfo",
    "-Xcompiler", "-fPIC", "--resource-usage",
]

#: Sentinel key of dead rows; sorts to the end (csrc O2V_INV).
INVALID_KEY = (1 << 31) - 1

#: Slots a block of K1 clips at a time (csrc/fused_pass.cu COMPACT_TILE).
COMPACT_TILE = 256

#: Launch counts of the kernels.  Each wrapper adds one where it launches
#: its kernel and nowhere else.
LAUNCHES = {"fused_pass": 0, "segment_combine": 0, "pack_exact": 0,
            "combine_pack": 0, "clip_pairs": 0, "pack_channels": 0,
            "merge_runs": 0, "plan_hist": 0, "plan_keys": 0, "plan_scatter": 0}

#: Seconds the last build took (None: loaded from an existing build).
BUILD_SECONDS = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # keys_out, 4 channels (out), counts_out, each (B, ...); look-back status
    # words + ticket (8-byte aligned; the launcher zeroes them), table,
    # n_table_rows, host (B, 5) (r0, n_rows, local_base, z_lo, z_hi), B,
    # stride, log2_expand, budget, wide_local, ref_weights, textured, stream
    "o2v_fused_pass": [_P] * 6 + [_P] + [_P, _I, _P] + [_I] * 7 + [_P],
    # keys, w, r, g, b, out x5, count_out, scratch (16-byte aligned; the
    # launcher zeroes its flags), n, combine, compact, is_blend, stream
    "o2v_reduce_by_key": [_P] * 5 + [_P] * 5 + [_P, _P] + [_I] * 4 + [_P],
    # tri (16, n), vox (4, n), out (4, n), n, stream
    "o2v_clip_pairs": [_P, _P, _P, _I, _P],
    # keys, w, r, g, b, out x5, count_out, status words + ticket (8-byte
    # aligned; the launcher zeroes them), n, stream
    "o2v_pack_channels": [_P] * 5 + [_P] * 5 + [_P, _P] + [_I, _P],
    # keys, w, r, g, b, out x5, composite scratch, level plans (host),
    # n_levels, n, stream
    "o2v_merge_runs": [_P] * 5 + [_P] * 5 + [_P, _P] + [_I, _I] + [_P],
    # table, vmin, vmax, diff (zeroed), n, n_sub, stride, z_extent, shared,
    # stream
    "o2v_plan_hist": [_P] * 4 + [_I] * 5 + [_P],
    # vmin, vmax, keys, counts, n_act, n_sub, group, s_pad, n_slabs, starts
    # and stops (host int32), units, chunk, stream
    "o2v_plan_keys": [_P] * 4 + [_I] * 5 + [_P, _P] + [_I, _I] + [_P],
    # keys, counts, inclusive counts, order, n_act, s_pad, units, chunk, stream
    "o2v_plan_scatter": [_P] * 4 + [_I] * 4 + [_P],
}

_LIB = None
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def reset_launches():
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str, n: int = 1):
    """Add n launches to `name`'s count (under a lock: parallel/mesh.py
    launches from one thread per device)."""
    with _COUNT_LOCK:
        LAUNCHES[name] += n


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libo2v_kernels_{h.hexdigest()[:16]}.so"


def resource_log_path() -> Path:
    """ptxas's resource usage of every kernel of the library, written by
    `build` beside it."""
    return library_path().with_suffix(".ptxas.txt")


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it exists: one nvcc
    per source, all started together, then one link.  ptxas's resource
    usage of each source goes to `resource_log_path()`."""
    global BUILD_SECONDS
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed, log = [], []
    for src, obj, proc in jobs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{obj.name}: nvcc failed ({proc.returncode}):\n{out}")
        log.append(f"== {src.name}\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        resource_log_path().write_text("\n".join(log))
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    BUILD_SECONDS = time.perf_counter() - t0
    return so


def lib():
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.o2v_error_string.argtypes = [ctypes.c_int]
            handle.o2v_error_string.restype = ctypes.c_char_p
            _LIB = handle
    return _LIB


def check(err: int, what: str):
    if err != 0:
        msg = lib().o2v_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors):
    """Shape-independent checks shared by the wrappers: every tensor on one
    CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev
