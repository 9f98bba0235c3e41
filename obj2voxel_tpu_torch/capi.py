"""The C shim over the port: its Python side, and its build.

native/ builds libobj2voxel_tpu_torch.so from native/src/capi.cpp, the
JAX package's shim of include/obj2voxel.h, with one import sent here
instead of to obj2voxel_tpu.api (native/src/capi_torch.h).  This module is
the port's API with one change: a C caller cannot pass a device, so
`Instance()` takes it from the environment variable OBJ2VOXEL_DEVICE
("cuda" when unset), as the JAX package's shim takes its platform from
JAX_PLATFORMS.

`build_shim` configures native/ with CMake and builds the shim and its
smoke test `capi_test_torch` (native/test/capi_test.c: the unit cube's
closed-form count at r = 32 through the callback API); `shim_env` is the
environment that test runs in.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

from . import api
from .api import Texture, Triangle, get_log_level, set_log_callback, set_log_level

__all__ = ["Instance", "Texture", "Triangle", "build_shim", "get_log_level",
           "set_log_callback", "set_log_level", "shim_env"]

#: The checkout's root, which holds native/.
ROOT = Path(__file__).resolve().parent.parent


class Instance(api.Instance):
    """api.Instance on the device OBJ2VOXEL_DEVICE names (default cuda)."""

    def __init__(self, device=None):
        super().__init__(os.environ.get("OBJ2VOXEL_DEVICE", "cuda")
                         if device is None else device)


def build_shim(build_dir) -> Path:
    """Configure native/ into `build_dir` (Ninja) and build the shim and
    `capi_test_torch`; returns the test executable's path."""
    build_dir = Path(build_dir)
    for cmd in (
        ["cmake", "-S", str(ROOT / "native"), "-B", str(build_dir), "-G", "Ninja",
         "-DCMAKE_BUILD_TYPE=Release", f"-DPython3_EXECUTABLE={sys.executable}"],
        ["cmake", "--build", str(build_dir), "--target", "capi_test_torch"],
    ):
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    return build_dir / "capi_test_torch"


def shim_env(device: str) -> dict:
    """The environment for a program that embeds the shim: this interpreter's
    import path (the embedded interpreter finds the same packages), the
    checkout on OBJ2VOXEL_TPU_PATH, and OBJ2VOXEL_DEVICE = device."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    env["OBJ2VOXEL_TPU_PATH"] = str(ROOT)
    env["OBJ2VOXEL_DEVICE"] = device
    return env
