"""Binary STL loading (reference: src/io.cpp:395-435).

Little-endian binary STL only; ASCII files (starting with "solid") are
rejected, normals are discarded, and triangles become materialless (white),
matching the reference's StlTriangleStream.
"""

from __future__ import annotations

import numpy as np

from ..soup import TriangleSoup
from ..utils.log import log


_RECORD = np.dtype(
    [("normal", "<f4", 3), ("verts", "<f4", (3, 3)), ("attr", "<u2")]
)
assert _RECORD.itemsize == 50


def load_stl(path: str) -> TriangleSoup | None:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        log.error(f'Failed to open STL file: "{path}"')
        return None

    if len(data) < 84:
        log.error("Binary STL file must start with a header of 80 characters")
        return None
    if data[:5] == b"solid":
        log.error("The given file is an ASCII STL file which is not supported")
        return None

    count = int(np.frombuffer(data, "<u4", count=1, offset=80)[0])
    need = 84 + count * 50
    if len(data) < need:
        log.error("Unexpected EOF or error when reading triangle")
        return None

    from .native import parse_stl_native

    try:
        verts = parse_stl_native(data)
    except ValueError:
        # validated above, so the native parser should never reject; keep the
        # reference's error text if it somehow does
        log.error("Unexpected EOF or error when reading triangle")
        return None
    if verts is None:  # no native library: numpy bulk parse
        records = np.frombuffer(data, _RECORD, count=count, offset=84)
        verts = np.ascontiguousarray(records["verts"], dtype=np.float32)
    return TriangleSoup.from_vertices(verts)
