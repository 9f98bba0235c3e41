"""Voxel output codecs: VL32, PLY, XYZRGB (streaming) and QEF, VOX (paletted).

Rebuilds the voxelio writer surface the reference uses
(reference: src/io.cpp:468-478, 524-636; format layouts documented in
README.adoc:210-263).  Streaming writers emit bytes per batch; paletted
writers buffer all voxels and build their palette at finalize, matching the
reference's buffered-vs-streaming split (requiresPalette).

All byte packing is vectorized numpy (native code under the hood); batches are
(K, 3) int32 positions + (K,) uint32 ARGB.
"""

from __future__ import annotations

import numpy as np

from ..utils.log import log

#: PLY header size is always exactly 300 bytes so that a PLY file is
#: bit-identical to VL32 plus header (reference README.adoc:231-237).
PLY_HEADER_SIZE = 300


def _pack_vl32(xyz: np.ndarray, argb: np.ndarray) -> bytes:
    """(x, y, z, argb) big-endian u32 quads (reference README.adoc:231-250)."""
    out = np.empty((xyz.shape[0], 4), dtype=">u4")
    out[:, :3] = xyz.astype(np.uint32)
    out[:, 3] = argb
    return out.tobytes()


class VoxelWriter:
    """Base class; subclasses stream or buffer."""

    requires_palette = False

    def __init__(self, stream, resolution: int):
        self.stream = stream
        self.resolution = int(resolution)
        self.voxels_written = 0
        self.finalized = False

    def write(self, xyz: np.ndarray, argb: np.ndarray):
        self.voxels_written += xyz.shape[0]
        self._write(xyz, argb)

    def _write(self, xyz, argb):
        raise NotImplementedError

    def finalize(self):
        if self.finalized:
            return
        self.finalized = True
        self._finalize()

    def _finalize(self):
        pass


class Vl32Writer(VoxelWriter):
    def _write(self, xyz, argb):
        self.stream.write(_pack_vl32(xyz, argb))


class PlyWriter(VoxelWriter):
    """Point-cloud PLY: big-endian int xyz + uchar argb per vertex
    (reference README.adoc:210-229)."""

    def __init__(self, stream, resolution):
        super().__init__(stream, resolution)
        self._header_pos = stream.tell() if stream.seekable() else None
        stream.write(self._header(0))

    def _header(self, count: int) -> bytes:
        lines = [
            b"ply",
            b"format binary_big_endian 1.0",
            b"element vertex %012d" % count,
            b"property int x",
            b"property int y",
            b"property int z",
            b"property uchar alpha",
            b"property uchar red",
            b"property uchar green",
            b"property uchar blue",
        ]
        body = b"\n".join(lines) + b"\n"
        tail = b"end_header\n"
        pad_len = PLY_HEADER_SIZE - len(body) - len(tail)
        assert pad_len >= len(b"comment \n"), "PLY header overflow"
        pad = b"comment " + b"x" * (pad_len - len(b"comment \n")) + b"\n"
        header = body + pad + tail
        assert len(header) == PLY_HEADER_SIZE
        return header

    def _write(self, xyz, argb):
        self.stream.write(_pack_vl32(xyz, argb))

    def _finalize(self):
        if self._header_pos is not None:
            end = self.stream.tell()
            self.stream.seek(self._header_pos)
            self.stream.write(self._header(self.voxels_written))
            self.stream.seek(end)


class XyzRgbWriter(VoxelWriter):
    """ASCII "x y z r g b" lines (FileToVox-compatible xyzrgb).

    Formatting goes through the native bulk formatter when available
    (native/src/meshparse.cpp); the Python join would take minutes at
    north-star voxel counts."""

    def _write(self, xyz, argb):
        from .native import format_xyzrgb_native

        buf = format_xyzrgb_native(np.asarray(xyz), np.asarray(argb))
        if buf is not None:
            self.stream.write(buf)
            return
        r = (argb >> 16) & 0xFF
        g = (argb >> 8) & 0xFF
        b = argb & 0xFF
        cols = np.column_stack([xyz, r, g, b]).astype(np.int64)
        lines = "\n".join(" ".join(map(str, row)) for row in cols)
        if lines:
            self.stream.write((lines + "\n").encode())


class _PalettedWriter(VoxelWriter):
    requires_palette = True

    def __init__(self, stream, resolution):
        super().__init__(stream, resolution)
        self._xyz: list[np.ndarray] = []
        self._argb: list[np.ndarray] = []

    def _write(self, xyz, argb):
        self._xyz.append(np.asarray(xyz))
        self._argb.append(np.asarray(argb))

    def _gather(self):
        if not self._xyz:
            return np.zeros((0, 3), np.int32), np.zeros((0,), np.uint32)
        return np.concatenate(self._xyz), np.concatenate(self._argb)


class QefWriter(_PalettedWriter):
    """Qubicle Exchange Format: ASCII header + palette + voxel lines."""

    def _finalize(self):
        xyz, argb = self._gather()
        colors, indices = np.unique(argb, return_inverse=True)
        r = self.resolution
        w = self.stream
        w.write(b"Qubicle Exchange Format\nVersion 0.2\nwww.minddesk.com\n")
        w.write(f"{r} {r} {r}\n".encode())
        w.write(f"{len(colors)}\n".encode())
        # all palette components are i/255 for byte i, so "%.6f" has exactly
        # 256 possible 8-char strings: format the palette as a fixed-width
        # byte matrix via a lookup table (vectorized, no per-color Python)
        if len(colors):
            lut = np.frombuffer(
                b"".join(b"%.6f" % (i / 255.0) for i in range(256)), np.uint8
            ).reshape(256, 8)
            line = np.empty((len(colors), 29), np.uint8)  # "r g b 0\n"
            line[:, 0:8] = lut[((colors >> 16) & 0xFF).astype(np.int64)]
            line[:, 8] = ord(" ")
            line[:, 9:17] = lut[((colors >> 8) & 0xFF).astype(np.int64)]
            line[:, 17] = ord(" ")
            line[:, 18:26] = lut[(colors & 0xFF).astype(np.int64)]
            line[:, 26] = ord(" ")
            line[:, 27] = ord("0")
            line[:, 28] = ord("\n")
            w.write(line.tobytes())

        from .native import format_qef_native

        buf = format_qef_native(xyz, indices)
        if buf is not None:
            w.write(buf)
            return
        vox = np.column_stack([xyz.astype(np.int64), indices.astype(np.int64)])
        vox_lines = "\n".join(f"{x} {y} {z} {i} 127" for x, y, z, i in vox)
        if len(vox):
            w.write((vox_lines + "\n").encode())


def _quantize_palette(argb: np.ndarray, max_colors: int = 255):
    """(palette uint32 (<=255,), indices) -- exact if few colors, else a
    median-cut-style reduction (the reference's VOX palette construction is
    acknowledged to be slow/experimental, README.adoc:253-258)."""
    colors, inverse, counts = np.unique(argb, return_inverse=True, return_counts=True)
    if len(colors) <= max_colors:
        return colors, inverse

    # Median-cut on the distinct colors, weighted by counts.
    rgb = np.stack(
        [(colors >> 16) & 0xFF, (colors >> 8) & 0xFF, colors & 0xFF], axis=1
    ).astype(np.int32)
    boxes = [np.arange(len(colors))]
    while len(boxes) < max_colors:
        # split the box with the largest channel spread
        spreads = [
            (rgb[b].max(0) - rgb[b].min(0)).max() if len(b) > 1 else -1 for b in boxes
        ]
        i = int(np.argmax(spreads))
        if spreads[i] <= 0:
            break
        b = boxes[i]
        ch = int(np.argmax(rgb[b].max(0) - rgb[b].min(0)))
        order = b[np.argsort(rgb[b, ch], kind="stable")]
        # weighted median split
        cw = np.cumsum(counts[order])
        half = int(np.searchsorted(cw, cw[-1] / 2))
        half = min(max(half, 1), len(order) - 1)
        boxes[i] = order[:half]
        boxes.append(order[half:])

    centers = np.empty((len(boxes), 3), np.float64)
    color_to_box = np.empty(len(colors), np.int64)
    for bi, b in enumerate(boxes):
        w = counts[b].astype(np.float64)
        centers[bi] = (rgb[b] * w[:, None]).sum(0) / w.sum()
        color_to_box[b] = bi

    # Lloyd (k-means) refinement of the median-cut seed: reassign each
    # distinct color to its nearest center, recompute count-weighted means.
    # Median-cut alone splits along single channels and leaves visible banding
    # on smooth gradients; a few Lloyd sweeps cut mean squared error ~2x.
    assign = color_to_box
    fw = counts.astype(np.float64)
    for _ in range(10):
        new_assign = np.empty(len(colors), np.int64)
        for c0 in range(0, len(colors), 1 << 14):  # bound the distance matrix
            blk = slice(c0, min(c0 + (1 << 14), len(colors)))
            d = ((rgb[blk, None, :] - centers[None, :, :]) ** 2).sum(-1)
            new_assign[blk] = d.argmin(1)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
        wsum = np.bincount(assign, weights=fw, minlength=len(centers))
        for ch in range(3):
            s = np.bincount(assign, weights=rgb[:, ch] * fw, minlength=len(centers))
            nz = wsum > 0
            centers[nz, ch] = s[nz] / wsum[nz]  # empty clusters keep their seed

    q = np.clip(np.round(centers), 0, 255).astype(np.uint32)
    palette = 0xFF000000 | (q[:, 0] << 16) | (q[:, 1] << 8) | q[:, 2]
    return palette.astype(np.uint32), assign[inverse]


class VoxWriter(_PalettedWriter):
    """MagicaVoxel VOX: models of up to 256^3, split into a grid of models with
    scene-graph translations for larger resolutions."""

    MODEL = 256

    def _chunk(self, cid: bytes, content: bytes, children: bytes = b"") -> bytes:
        return (
            cid
            + np.uint32(len(content)).tobytes()
            + np.uint32(len(children)).tobytes()
            + content
            + children
        )

    def _finalize(self):
        xyz, argb = self._gather()
        palette, indices = _quantize_palette(argb, 255)
        m = self.MODEL
        r = self.resolution

        # split into model-grid cells
        cell = xyz // m
        local = (xyz % m).astype(np.uint8)
        cell_key = (cell[:, 0].astype(np.int64) << 42) | (
            cell[:, 1].astype(np.int64) << 21
        ) | cell[:, 2].astype(np.int64)
        uniq, cell_inv = np.unique(cell_key, return_inverse=True)

        children = b""
        model_cells = []
        for mi, key in enumerate(uniq):
            sel = cell_inv == mi
            cx, cy, cz = int(key >> 42), int((key >> 21) & 0x1FFFFF), int(key & 0x1FFFFF)
            dim = min(m, r - cx * m), min(m, r - cy * m), min(m, r - cz * m)
            model_cells.append((cx, cy, cz, dim))
            size = np.asarray(dim, np.uint32).tobytes()
            n = int(sel.sum())
            vox = np.empty((n, 4), np.uint8)
            vox[:, :3] = local[sel]
            vox[:, 3] = (indices[sel] + 1).astype(np.uint8)  # palette is 1-based
            content = np.uint32(n).tobytes() + vox.tobytes()
            children += self._chunk(b"SIZE", size)
            children += self._chunk(b"XYZI", content)

        if len(uniq) > 1:
            children += self._scene_graph(model_cells)

        # RGBA palette chunk: 256 colors; palette index i maps to entry i-1.
        rgba = np.zeros((256, 4), np.uint8)
        pr = (palette >> 16) & 0xFF
        pg = (palette >> 8) & 0xFF
        pb = palette & 0xFF
        k = len(palette)
        rgba[:k, 0] = pr
        rgba[:k, 1] = pg
        rgba[:k, 2] = pb
        rgba[:k, 3] = 255
        children += self._chunk(b"RGBA", rgba.tobytes())

        out = b"VOX " + np.uint32(150).tobytes() + self._chunk(b"MAIN", b"", children)
        self.stream.write(out)

    def _scene_graph(self, cells):
        """nTRN/nGRP/nSHP chain placing each model at its grid offset."""
        def dict_bytes(d: dict) -> bytes:
            out = np.uint32(len(d)).tobytes()
            for k, v in d.items():
                kb, vb = k.encode(), v.encode()
                out += np.uint32(len(kb)).tobytes() + kb
                out += np.uint32(len(vb)).tobytes() + vb
            return out

        m = self.MODEL
        chunks = b""
        # root transform (id 0) -> group (id 1) -> per-model transform/shape
        child_ids = [2 + 2 * i for i in range(len(cells))]
        root_t = (
            np.int32(0).tobytes()
            + dict_bytes({})
            + np.int32(1).tobytes()
            + np.int32(-1).tobytes()
            + np.int32(-1).tobytes()
            + np.int32(1).tobytes()
            + dict_bytes({})
        )
        chunks += self._chunk(b"nTRN", root_t)
        grp = (
            np.int32(1).tobytes()
            + dict_bytes({})
            + np.int32(len(cells)).tobytes()
            + b"".join(np.int32(c).tobytes() for c in child_ids)
        )
        chunks += self._chunk(b"nGRP", grp)
        for i, (cx, cy, cz, dim) in enumerate(cells):
            tid, sid = child_ids[i], child_ids[i] + 1
            # MagicaVoxel places a model's CENTER at the translation: a voxel
            # at model-local p maps to world t + p - size//2, so edge cells
            # (size < 256) must offset by their own half-size, not 128
            tx = cx * m + dim[0] // 2
            ty = cy * m + dim[1] // 2
            tz = cz * m + dim[2] // 2
            trn = (
                np.int32(tid).tobytes()
                + dict_bytes({})
                + np.int32(sid).tobytes()
                + np.int32(-1).tobytes()
                + np.int32(-1).tobytes()
                + np.int32(1).tobytes()
                + dict_bytes({"_t": f"{tx} {ty} {tz}"})
            )
            chunks += self._chunk(b"nTRN", trn)
            shp = (
                np.int32(sid).tobytes()
                + dict_bytes({})
                + np.int32(1).tobytes()
                + np.int32(i).tobytes()
                + dict_bytes({})
            )
            chunks += self._chunk(b"nSHP", shp)
        return chunks


class CallbackSink:
    """Streams VL32-layout uint32 quads to a user callback
    (reference: src/io.cpp:480-513, 638-653)."""

    requires_palette = False

    def __init__(self, callback):
        self.callback = callback
        self.voxels_written = 0
        self.good = True

    def write(self, xyz: np.ndarray, argb: np.ndarray):
        data = np.empty((xyz.shape[0], 4), np.uint32)
        data[:, :3] = xyz.astype(np.uint32)
        data[:, 3] = argb
        self.voxels_written += xyz.shape[0]
        ok = self.callback(data, xyz.shape[0])
        self.good = self.good and bool(ok)

    def finalize(self):
        log.debug("Flushing callback sink (no-op)")


WRITERS = {
    "vl32": Vl32Writer,
    "ply": PlyWriter,
    "xyzrgb": XyzRgbWriter,
    "qef": QefWriter,
    "vox": VoxWriter,
}

INPUT_FORMATS = ("obj", "stl")
OUTPUT_FORMATS = ("ply", "qef", "vl32", "vox", "xyzrgb")
IMAGE_FORMATS = ("png", "jpg", "jpeg", "bmp", "tga")


def detect_file_type(path: str | None, explicit: str | None = None) -> str | None:
    """Extension-based file type detection (reference main.cpp:79-113)."""
    if explicit:
        ext = explicit.lower().lstrip(".")
        return ext if ext else None
    if path is None:
        return None
    dot = path.rfind(".")
    if dot < 0 or dot == len(path) - 1:
        return None
    return path[dot + 1 :].lower()


def make_writer(stream, file_type: str, resolution: int) -> VoxelWriter:
    cls = WRITERS.get(file_type)
    if cls is None:
        raise ValueError(f"Unsupported output format: {file_type}")
    return cls(stream, resolution)
