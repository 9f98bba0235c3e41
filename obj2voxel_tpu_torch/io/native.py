"""ctypes binding for the native mesh parsers (native/src/meshparse.cpp).

The shared library is optional: loaders fall back to their numpy bulk parsers
when it is absent.  Search order: O2V_NATIVE_LIB env var, then the repo's
native/build directory relative to this package.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


class _ObjMesh(ctypes.Structure):
    _fields_ = [
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("n_positions", ctypes.c_long),
        ("texcoords", ctypes.POINTER(ctypes.c_float)),
        ("n_texcoords", ctypes.c_long),
        ("tri_v", ctypes.POINTER(ctypes.c_int)),
        ("tri_vt", ctypes.POINTER(ctypes.c_int)),
        ("tri_mat", ctypes.POINTER(ctypes.c_int)),
        ("tri_face", ctypes.POINTER(ctypes.c_int)),
        ("n_tris", ctypes.c_long),
        ("usemtl_names", ctypes.c_char_p),
        ("usemtl_len", ctypes.c_long),
        ("mtllib_names", ctypes.c_char_p),
        ("mtllib_len", ctypes.c_long),
    ]


def _candidates():
    env = os.environ.get("O2V_NATIVE_LIB")
    if env:
        yield env
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(here))
    yield os.path.join(repo, "native", "build", "libo2vmesh.so")
    yield os.path.join(repo, "native", "libo2vmesh.so")


def get_lib():
    """Load (once) and return the native library, or None."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("O2V_NO_NATIVE") == "1":
        return None
    for path in _candidates():
        if not path or not os.path.exists(path):
            continue
        try:
            lib = ctypes.CDLL(path)
            lib.o2v_parse_obj.restype = ctypes.c_int
            lib.o2v_parse_obj.argtypes = [
                ctypes.c_char_p,
                ctypes.c_long,
                ctypes.POINTER(_ObjMesh),
            ]
            lib.o2v_obj_free.restype = None
            lib.o2v_obj_free.argtypes = [ctypes.POINTER(_ObjMesh)]
            lib.o2v_parse_stl.restype = ctypes.c_long
            lib.o2v_parse_stl.argtypes = [
                ctypes.c_char_p,
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_long,
            ]
            lib.o2v_format_xyzrgb.restype = ctypes.c_long
            lib.o2v_format_xyzrgb.argtypes = [
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_uint),
                ctypes.c_long,
                ctypes.c_char_p,
                ctypes.c_long,
            ]
            lib.o2v_format_qef.restype = ctypes.c_long
            lib.o2v_format_qef.argtypes = [
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_long),
                ctypes.c_long,
                ctypes.c_char_p,
                ctypes.c_long,
            ]
            _LIB = lib
            break
        except OSError:
            continue
    return _LIB


def _copy(ptr, n, dtype, cols=None):
    if n == 0:
        shape = (0, cols) if cols else (0,)
        return np.zeros(shape, dtype)
    count = n * (cols or 1)
    arr = np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)
    return arr.reshape(n, cols) if cols else arr


def parse_obj_native(content: bytes):
    """Parse OBJ bytes with the native tokenizer.

    Returns (positions (P,3) f32, texcoords (T,2) f32, tri_v (N,3) i64,
    tri_vt (N,3) i64, tri_mat (N,) i32, tri_face (N,) i32, usemtl_names,
    mtllib_names) or None if the library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    mesh = _ObjMesh()
    rc = lib.o2v_parse_obj(content, len(content), ctypes.byref(mesh))
    if rc != 0:
        lib.o2v_obj_free(ctypes.byref(mesh))
        raise MemoryError("o2v_parse_obj failed")
    try:
        out = (
            _copy(mesh.positions, mesh.n_positions, np.float32, 3),
            _copy(mesh.texcoords, mesh.n_texcoords, np.float32, 2),
            _copy(mesh.tri_v, mesh.n_tris, np.int64, 3),
            _copy(mesh.tri_vt, mesh.n_tris, np.int64, 3),
            _copy(mesh.tri_mat, mesh.n_tris, np.int32),
            _copy(mesh.tri_face, mesh.n_tris, np.int32),
            (mesh.usemtl_names or b"").decode("utf-8", "replace").split("\n")
            if mesh.usemtl_len
            else [],
            (mesh.mtllib_names or b"").decode("utf-8", "replace").split("\n")
            if mesh.mtllib_len
            else [],
        )
    finally:
        lib.o2v_obj_free(ctypes.byref(mesh))
    return out


def format_xyzrgb_native(xyz: np.ndarray, argb: np.ndarray):
    """Bulk-format "x y z r g b" lines; returns bytes or None (no library)."""
    lib = get_lib()
    if lib is None:
        return None
    n = xyz.shape[0]
    xyz = np.ascontiguousarray(xyz, np.int32)
    argb = np.ascontiguousarray(argb, np.uint32)
    out = ctypes.create_string_buffer(n * 48)  # worst-case 48 B/line
    got = lib.o2v_format_xyzrgb(
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        argb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint)),
        n, out, n * 48,
    )
    return out.raw[:got] if got >= 0 else None


def format_qef_native(xyz: np.ndarray, idx: np.ndarray):
    """Bulk-format "x y z i 127" lines; returns bytes or None (no library)."""
    lib = get_lib()
    if lib is None:
        return None
    n = xyz.shape[0]
    xyz = np.ascontiguousarray(xyz, np.int32)
    idx = np.ascontiguousarray(idx, np.int64)
    out = ctypes.create_string_buffer(n * 61)  # worst-case 61 B/line
    got = lib.o2v_format_qef(
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n, out, n * 61,
    )
    return out.raw[:got] if got >= 0 else None


def parse_stl_native(content: bytes):
    """Parse binary STL bytes; returns (N, 3, 3) f32 verts or None."""
    lib = get_lib()
    if lib is None or len(content) < 84:
        return None
    n = int.from_bytes(content[80:84], "little")
    verts = np.empty((n, 3, 3), np.float32)
    got = lib.o2v_parse_stl(
        content,
        len(content),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
    )
    if got < 0:
        raise ValueError("malformed binary STL")
    return verts[:got]
