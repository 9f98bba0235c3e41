"""Public instance-based API mirroring the reference's C API.

The port of obj2voxel_tpu/api.py: every function of include/obj2voxel.h has
a counterpart here with the same semantics, validation order, and error
codes (reference: obj2voxel.h:89-406, obj2voxel.cpp:602-637).  An Instance
runs on one CUDA device unless it is given another (`Instance("cpu")`);
with set_parallel(True) on a CUDA device and more than one card visible it
streams one z window a card (parallel/mesh.py).

Usage:
    inst = Instance()
    inst.set_input_file("in.obj")
    inst.set_output_file("out.vl32")
    inst.set_resolution(128)
    err = inst.voxelize()
"""

from __future__ import annotations

import io as _io
import os
import time

import numpy as np

from . import constants as C
from .engine import timing_line, voxelize_soup
from .io.obj_loader import load_obj
from .io.png_io import argb_to_pixels, load_image, load_image_bytes, pixels_to_argb
from .io.stl_loader import load_stl
from .io.writers import (
    CallbackSink,
    INPUT_FORMATS,
    OUTPUT_FORMATS,
    IMAGE_FORMATS,
    detect_file_type,
    make_writer,
)
from .parallel.mesh import parallel_devices, stream_sharded
from .soup import TexturePool, TriangleSoup
from .utils.log import log


def set_log_level(level: int):
    """obj2voxel_set_log_level (reference obj2voxel.h:105)."""
    log.set_level(level)


def get_log_level() -> int:
    """obj2voxel_get_log_level."""
    return log.get_level()


def set_log_callback(callback):
    """obj2voxel_set_log_callback; callback(msg, level) -> handled?"""
    log.set_callback(callback)


class Texture:
    """obj2voxel_texture: an ARGB image with a wrap mode
    (reference: src/triangle.hpp:151-167)."""

    def __init__(self):
        self.argb: np.ndarray | None = None  # (H, W) uint32
        self.wrap = C.UV_WRAP

    def load_from_file(self, path: str, file_type: str | None = None) -> bool:
        ftype = detect_file_type(path, file_type)
        if ftype not in IMAGE_FORMATS:
            return False
        img = load_image(path)
        if img is None:
            return False
        self.argb = img
        return True

    def load_from_memory(self, data: bytes, file_type: str | None = None) -> bool:
        if file_type is not None and file_type.lower().lstrip(".") not in IMAGE_FORMATS:
            return False
        img = load_image_bytes(data)
        if img is None:
            return False
        self.argb = img
        return True

    def load_pixels(self, pixels, width: int, height: int, channels: int) -> bool:
        self.argb = pixels_to_argb(np.asarray(pixels, np.uint8), width, height, channels)
        return True

    def set_uv_mode(self, mode: int):
        self.wrap = int(mode)

    def get_meta(self):
        assert self.argb is not None, "Can't get metadata of empty image"
        h, w = self.argb.shape
        return w, h, 4

    def get_pixels(self) -> np.ndarray:
        assert self.argb is not None, "Can't get pixels of empty image"
        return argb_to_pixels(self.argb, 4)


class Triangle:
    """obj2voxel_triangle: mutable triangle passed to input callbacks
    (reference obj2voxel.h:272-292)."""

    __slots__ = ("vertices", "uvs", "type", "color", "texture")

    def __init__(self):
        self.vertices = np.zeros((3, 3), np.float32)
        self.uvs = np.zeros((3, 2), np.float32)
        self.type = C.TRI_NONE
        self.color = np.ones(3, np.float32)
        self.texture: Texture | None = None

    def set_basic(self, vertices):
        self.vertices = np.asarray(vertices, np.float32).reshape(3, 3)
        self.type = C.TRI_MATERIALLESS
        self.texture = None

    def set_colored(self, vertices, color):
        self.vertices = np.asarray(vertices, np.float32).reshape(3, 3)
        self.color = np.asarray(color, np.float32).reshape(3)
        # NOTE: the reference's obj2voxel_set_triangle_colored sets
        # MATERIALLESS (obj2voxel.cpp:828-837), which makes the color unused;
        # we implement the documented intent (UNTEXTURED).
        self.type = C.TRI_UNTEXTURED
        self.texture = None

    def set_textured(self, vertices, uvs, texture: Texture):
        self.vertices = np.asarray(vertices, np.float32).reshape(3, 3)
        self.uvs = np.asarray(uvs, np.float32).reshape(3, 2)
        self.type = C.TRI_TEXTURED
        self.texture = texture


class Instance:
    """obj2voxel_instance: one-shot voxelization configuration + execution
    (reference: obj2voxel.cpp:142-173) on `device`."""

    def __init__(self, device="cuda"):
        self.device = device
        self._input = None  # ("file", path, type) | ("callback", fn) | ("soup", TriangleSoup, pool)
        self._output = None  # ("file", path, type) | ("memory", type) | ("callback", fn)
        self._default_texture: Texture | None = None
        self._resolution = 0
        self._supersampling = 1
        self._strategy = C.MAX_STRATEGY
        self._parallel = False
        self._unit_transform = [1, 0, 0, 0, 1, 0, 0, 0, 1]
        self._bounds = None
        self._done = False
        self._memory = None
        self._pair_tile = C.PAIR_TILE

    # --- settings (reference obj2voxel.h:122-263) ---

    def set_resolution(self, resolution: int):
        assert resolution != 0
        self._resolution = int(resolution)

    def set_supersampling(self, level: int):
        assert level in (1, 2)
        self._supersampling = int(level)

    def set_color_strategy(self, strategy: int):
        assert strategy in (C.MAX_STRATEGY, C.BLEND_STRATEGY)
        self._strategy = int(strategy)

    def set_texture(self, texture: Texture):
        self._default_texture = texture

    def set_input_file(self, path: str, file_type: str | None = None):
        self._input = ("file", path, detect_file_type(path, file_type))

    def set_input_callback(self, callback):
        """callback(triangle: Triangle) -> bool (False = end of stream)."""
        self._input = ("callback", callback)

    def set_input_soup(self, soup: TriangleSoup, pool: TexturePool | None = None):
        """Direct array input (no reference analog)."""
        self._input = ("soup", soup, pool)

    def set_output_file(self, path: str, file_type: str | None = None):
        self._output = ("file", path, detect_file_type(path, file_type))

    def set_output_memory(self, file_type: str):
        assert file_type is not None
        self._output = ("memory", detect_file_type(None, file_type))

    def set_output_callback(self, callback):
        """callback(data: (K,4) uint32 VL32-layout array, count) -> bool."""
        self._output = ("callback", callback)

    def set_parallel(self, enabled: bool):
        self._parallel = bool(enabled)

    def set_unit_transform(self, transform9):
        self._unit_transform = [int(x) for x in transform9]
        assert len(self._unit_transform) == 9

    def set_mesh_boundaries(self, bounds6):
        b = [float(x) for x in bounds6]
        assert len(b) == 6
        assert all(np.isfinite(b)), "Infinite mesh boundaries provided"
        lo, hi = np.asarray(b[:3], np.float32), np.asarray(b[3:], np.float32)
        assert np.all(lo <= hi), "Lower mesh bound must be <= the maximum on each axis"
        self._bounds = (lo, hi)

    def get_resolution(self) -> int:
        return self._resolution

    def get_chunk_size(self) -> int:
        return C.CHUNK_SIZE

    def get_output_memory(self) -> bytes | None:
        if self._memory is None:
            return None
        return self._memory.getvalue()

    # --- threading shims (reference obj2voxel.h:374-396).  The engine has no
    # host worker pool; workers are accepted and counted for API
    # compatibility but all compute runs through the device pipeline. ---

    def run_worker(self):
        self._workers = getattr(self, "_workers", 0) + 1

    def stop_workers(self):
        self._workers = 0

    def get_worker_count(self) -> int:
        return getattr(self, "_workers", 0)

    # --- voxelization (reference obj2voxel.cpp:602-637) ---

    def voxelize(self) -> int:
        if self._done:
            return C.ERR_DOUBLE_VOXELIZATION
        if self._input is None:
            log.error("No input was specified")
            return C.ERR_NO_INPUT
        if self._output is None:
            log.error("No output was specified")
            return C.ERR_NO_OUTPUT
        if self._resolution == 0:
            log.error("No resolution was specified")
            return C.ERR_NO_RESOLUTION

        timing = os.environ.get("O2V_TIMING") == "1"
        t0 = time.perf_counter()
        loaded = self._open_input()
        if loaded is None:
            return C.ERR_IO_ERROR_ON_OPEN_INPUT_FILE
        soup, pool = loaded
        if timing:
            dt = time.perf_counter() - t0
            timing_line("load", dt, f"load {dt * 1000:.0f}ms ({len(soup)} triangles)")

        sink, close = self._open_output()
        if sink is None:
            return C.ERR_IO_ERROR_ON_OPEN_OUTPUT_FILE

        self._done = True
        try:
            if len(soup) == 0:
                log.warning("Model has no triangles, aborting and writing empty voxel model")
                sink.finalize()
                return C.ERR_OK
            log.info(f"Cached model with {len(soup)} triangles")

            opts = dict(
                resolution=self._resolution,
                supersampling=self._supersampling,
                strategy=self._strategy,
                unit_transform=self._unit_transform,
                bounds=self._bounds,
                pair_tile=self._pair_tile,
            )
            devices = parallel_devices(self.device) if self._parallel else []
            if len(devices) > 1:
                # z windows over the devices (reference chunk parallelism,
                # obj2voxel.cpp:503-507); batches reach the sink in
                # completion order
                batches = stream_sharded(soup, pool, devices=devices, **opts)
            else:
                batches = voxelize_soup(soup, pool, device=self.device, **opts)

            ok, t_write, n_writes = True, 0.0, 0
            for xyz, argb in batches:
                t1 = time.perf_counter()
                try:
                    sink.write(xyz, argb)
                except OSError:
                    ok = False
                    break
                t_write += time.perf_counter() - t1
                n_writes += 1
                if getattr(sink, "good", True) is False:
                    ok = False
                    break
            if not ok:
                log.error("Voxelization failed because of IO error")
                return C.ERR_IO_ERROR_DURING_VOXEL_WRITE
            t1 = time.perf_counter()
            sink.finalize()
            if timing:
                t_write += time.perf_counter() - t1
                timing_line("write", t_write, f"write {t_write * 1000:.0f}ms "
                            f"({n_writes} batches, {sink.voxels_written} voxels)")
            log.info(f"All {sink.voxels_written} voxels written")
            return C.ERR_OK
        finally:
            if close is not None:
                close()

    # --- helpers ---

    def _open_input(self):
        kind = self._input[0]
        if kind == "soup":
            return self._input[1], self._input[2]
        if kind == "callback":
            return self._drain_callback(self._input[1])
        _, path, ftype = self._input
        if ftype == "stl":
            soup = load_stl(path)
            return None if soup is None else (soup, None)
        # OBJ fallback for unknown input types matches the CLI's behavior
        pool = TexturePool()
        default_id = -1
        if self._default_texture is not None and self._default_texture.argb is not None:
            default_id = pool.add(self._default_texture.argb, self._default_texture.wrap)
        result = load_obj(path, default_id, pool)
        return result

    def _drain_callback(self, callback):
        tri = Triangle()
        verts, uvs, types, rgbs, texs = [], [], [], [], []
        pool = TexturePool()
        tex_ids: dict[int, int] = {}
        default_id = None

        def texture_id(tex: Texture | None) -> int:
            nonlocal default_id
            if tex is None:
                if self._default_texture is None or self._default_texture.argb is None:
                    return -1
                if default_id is None:
                    default_id = pool.add(
                        self._default_texture.argb, self._default_texture.wrap
                    )
                return default_id
            key = id(tex)
            if key not in tex_ids:
                assert tex.argb is not None
                tex_ids[key] = pool.add(tex.argb, tex.wrap)
            return tex_ids[key]

        while callback(tri):
            verts.append(tri.vertices.copy())
            uvs.append(tri.uvs.copy())
            types.append(tri.type if tri.type != C.TRI_NONE else C.TRI_MATERIALLESS)
            rgbs.append(
                tri.color.copy() if tri.type == C.TRI_UNTEXTURED else np.ones(3, np.float32)
            )
            texs.append(texture_id(tri.texture) if tri.type == C.TRI_TEXTURED else -1)

        n = len(verts)
        if n == 0:
            return TriangleSoup.empty(), pool
        soup = TriangleSoup(
            verts=np.stack(verts),
            uvs=np.stack(uvs),
            types=np.asarray(types, np.int32),
            rgb=np.stack(rgbs),
            tex=np.asarray(texs, np.int32),
        )
        return soup, pool

    def _open_output(self):
        kind = self._output[0]
        if kind == "callback":
            return CallbackSink(self._output[1]), None
        if kind == "memory":
            ftype = self._output[1]
            if ftype not in OUTPUT_FORMATS:
                return None, None
            self._memory = _io.BytesIO()
            return make_writer(self._memory, ftype, self._resolution), None
        _, path, ftype = self._output
        if ftype not in OUTPUT_FORMATS:
            return None, None
        try:
            f = open(path, "wb")
        except OSError:
            return None, None
        return make_writer(f, ftype, self._resolution), f.close
