"""Binary STL loading (reference: src/io.cpp:395-435).

Little-endian binary STL only; ASCII files (starting with "solid") are
rejected, normals are discarded, and triangles become materialless (white),
matching the reference's StlTriangleStream.  Without the native parser
the file is read in chunks of CHUNK_RECORDS records, so a 10M-triangle file
(500 MB) costs the host its vertices and one chunk; the native parser takes
the whole file's bytes (one copy) and its vertices.
"""

from __future__ import annotations

import os

import numpy as np

from ..soup import TriangleSoup
from ..utils.log import log


_RECORD = np.dtype(
    [("normal", "<f4", 3), ("verts", "<f4", (3, 3)), ("attr", "<u2")]
)
assert _RECORD.itemsize == 50


#: Records parsed per read when the native parser is absent: the host holds
#: the (N, 3, 3) vertices and one 50 MB chunk of the file, never the file.
CHUNK_RECORDS = 1 << 20


def load_stl(path: str) -> TriangleSoup | None:
    try:
        f = open(path, "rb")
    except OSError:
        log.error(f'Failed to open STL file: "{path}"')
        return None
    with f:
        head = f.read(84)
        size = os.fstat(f.fileno()).st_size
        if len(head) < 84:
            log.error("Binary STL file must start with a header of 80 characters")
            return None
        if head[:5] == b"solid":
            log.error("The given file is an ASCII STL file which is not supported")
            return None

        count = int.from_bytes(head[80:84], "little")
        if size < 84 + count * 50:
            log.error("Unexpected EOF or error when reading triangle")
            return None

        from .native import get_lib, parse_stl_native

        if get_lib() is None:  # no native library: numpy bulk parse by chunks
            verts = _read_verts(f, count)
            if verts is None:
                log.error("Unexpected EOF or error when reading triangle")
                return None
            return TriangleSoup.from_vertices(verts)
        f.seek(0)
        try:
            verts = parse_stl_native(f.read())
        except ValueError:
            # validated above, so the native parser should never reject; keep
            # the reference's error text if it somehow does
            log.error("Unexpected EOF or error when reading triangle")
            return None
    return TriangleSoup.from_vertices(verts)


def _read_verts(f, count: int) -> np.ndarray | None:
    """The vertices of the next `count` records of `f`, (count, 3, 3), or
    None if the file ends before them."""
    verts = np.empty((count, 3, 3), np.float32)
    buf = bytearray(min(count, CHUNK_RECORDS) * _RECORD.itemsize)
    for i in range(0, count, CHUNK_RECORDS):
        m = min(CHUNK_RECORDS, count - i)
        view = memoryview(buf)[: m * _RECORD.itemsize]
        if f.readinto(view) != len(view):
            return None
        verts[i : i + m] = np.frombuffer(view, _RECORD)["verts"]
    return verts
