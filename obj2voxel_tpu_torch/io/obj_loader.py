"""Wavefront OBJ + MTL loading (reference: src/io.cpp:194-393 via tinyobj).

Produces a TriangleSoup + TexturePool.  Material resolution follows the
reference's ObjTriangleStream::next (io.cpp:276-303):

* no material: textured with the instance's fallback texture when the face has
  UVs and a fallback was provided, else materialless (white);
* material with a diffuse texture and face UVs: textured;
* otherwise: flat diffuse color.

Texture paths get backslashes replaced by '/' (io.cpp:437-441) and textures are
loaded with REPEAT wrap (io.cpp:456).  Faces with more than three vertices are
fan-triangulated, which is tinyobj's default triangulation.

Three parser tiers produce identical (positions, texcoords, tri_v, tri_vt,
tri_mat, tri_face, usemtl, mtllib) tuples; material POLICY is shared:

1. native/src/meshparse.cpp via ctypes (one C++ pass, the counterpart of the
   reference's tinyobj dependency);
2. a numpy bulk parser: lines classified by leading bytes, payloads parsed
   with np.fromstring on joined byte runs, faces grouped by (corner count,
   slashes per corner) so each group fan-triangulates as fixed-shape array
   ops;
3. a per-line Python loop for files the bulk parser rejects (ragged vertex
   lines, mixed face formats).
"""

from __future__ import annotations

import os

import numpy as np

from ..constants import TRI_MATERIALLESS, TRI_TEXTURED, TRI_UNTEXTURED, UV_WRAP
from ..soup import TexturePool, TriangleSoup
from ..utils.log import log
from .native import parse_obj_native
from .png_io import load_image


def _parse_mtl(path: str):
    """Parse an MTL file -> {name: {"kd": (r,g,b), "map_kd": str|None}}."""
    materials = {}
    cur = None
    try:
        with open(path, "r", errors="replace") as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                key = parts[0]
                if key == "newmtl" and len(parts) > 1:
                    cur = {"kd": (1.0, 1.0, 1.0), "map_kd": None}
                    materials[parts[1]] = cur
                elif cur is None:
                    continue
                elif key == "Kd" and len(parts) >= 4:
                    cur["kd"] = tuple(float(x) for x in parts[1:4])
                elif key == "map_Kd" and len(parts) > 1:
                    # the texture name is the last token (options are rare)
                    cur["map_kd"] = parts[-1]
    except OSError:
        log.warning(f"Failed to open material library {path}")
    return materials


def _load_mtllibs(names, obj_dir):
    materials = {}
    for name in names:
        if not name:
            continue
        mtl_path = name if os.path.isabs(name) else os.path.join(obj_dir, name)
        if not os.path.exists(mtl_path) and os.path.exists(name):
            mtl_path = name
        materials.update(_parse_mtl(mtl_path))
    return materials


# --- numpy bulk parser -------------------------------------------------------


def _extract_lines(data: np.ndarray, starts, ends, skip: int) -> bytes:
    """Join byte ranges [starts+skip, ends+1) (trailing newline kept as a
    separator) into one bytes object via a ragged cumulative-index take.
    int32 throughout: OBJ files handled here are < 2 GiB."""
    s = (starts + skip).astype(np.int32)
    e = (ends + 1).astype(np.int32)  # include the newline as a separator
    lens = np.maximum(e - s, 0)
    total = int(lens.sum())
    if total == 0:
        return b""
    step = np.full(total, 1, np.int32)
    step[0] = s[0]
    cuts = np.cumsum(lens, dtype=np.int32)[:-1]
    step[cuts] = s[1:] - e[:-1] + 1
    return data[np.cumsum(step, dtype=np.int32)].tobytes()


def _token_table(buf: bytes, dtype, per_line: int, n_lines: int, what: str):
    """Parse whitespace-separated numbers; require a uniform column count."""
    arr = np.fromstring(buf, dtype=dtype, sep=" ")
    if n_lines == 0:
        return arr.reshape(0, per_line)
    if arr.size % n_lines:
        raise ValueError(f"ragged {what} lines in OBJ")
    return arr.reshape(n_lines, arr.size // n_lines)


def _parse_obj_numpy(content: bytes):
    """Bulk-vectorized OBJ tokenizer; raises ValueError on ragged layouts."""
    if b"\r" in content:
        content = content.replace(b"\r", b"")
    if not content.endswith(b"\n"):
        content += b"\n"

    data = np.frombuffer(content, np.uint8)
    nl = np.flatnonzero(data == 10).astype(np.int32)
    n_lines = nl.size
    starts = np.empty(n_lines, np.int32)
    starts[0] = 0
    starts[1:] = nl[:-1] + 1
    ends = nl  # exclusive of the newline

    pad = np.zeros(3, np.uint8)
    dpad = np.concatenate([data, pad])
    c0 = dpad[starts]
    c1 = dpad[starts + 1]
    c2 = dpad[starts + 2]
    nonempty = ends > starts

    def ws(c):
        return (c == 32) | (c == 9)

    v_mask = nonempty & (c0 == ord("v")) & ws(c1)
    vt_mask = nonempty & (c0 == ord("v")) & (c1 == ord("t")) & ws(c2)
    f_mask = nonempty & (c0 == ord("f")) & ws(c1)
    # directive lines (usemtl/mtllib/...) are rare; handle them in Python
    dir_mask = nonempty & ((c0 == ord("u")) | (c0 == ord("m")))

    usemtl_lines: list[int] = []
    usemtl_names: list[str] = []
    mtllib_names: list[str] = []
    for li in np.flatnonzero(dir_mask):
        parts = content[starts[li] : ends[li]].decode("utf-8", "replace").split()
        if not parts:
            continue
        if parts[0] == "usemtl":
            usemtl_lines.append(int(li))
            usemtl_names.append(parts[1] if len(parts) > 1 else "")
        elif parts[0] == "mtllib":
            mtllib_names.extend(parts[1:])

    # --- vertex positions and texcoords (bulk float parse) ------------------
    v_lines = np.flatnonzero(v_mask)
    vcols = _token_table(
        _extract_lines(data, starts[v_lines], ends[v_lines], 2),
        np.float32, 3, v_lines.size, "v",
    )
    if vcols.shape[1] < 3:
        raise ValueError("short v lines in OBJ")
    positions = np.ascontiguousarray(vcols[:, :3])
    n_pos = positions.shape[0]

    vt_lines = np.flatnonzero(vt_mask)
    if vt_lines.size:
        tcols = _token_table(
            _extract_lines(data, starts[vt_lines], ends[vt_lines], 3),
            np.float32, 2, vt_lines.size, "vt",
        )
        if tcols.shape[1] < 2:
            raise ValueError("short vt lines in OBJ")
        texcoords = np.ascontiguousarray(tcols[:, :2])
    else:
        texcoords = np.zeros((0, 2), np.float32)
    n_tc = texcoords.shape[0]

    # --- faces: group lines by (corner count, slashes per corner) -----------
    f_lines = np.flatnonzero(f_mask)
    empty = (
        positions,
        texcoords,
        np.zeros((0, 3), np.int64),
        np.zeros((0, 3), np.int64),
        np.zeros(0, np.int32),
        np.zeros(0, np.int32),
        usemtl_names,
        mtllib_names,
    )
    if f_lines.size == 0:
        return empty

    # per-byte token starts (non-whitespace preceded by whitespace)
    is_ws = (data == 32) | (data == 9) | (data == 10)
    tok_start = ~is_ws
    tok_start[1:] &= is_ws[:-1]
    tok_cum = np.concatenate([[0], np.cumsum(tok_start, dtype=np.int32)])
    line_tokens = tok_cum[ends] - tok_cum[starts]  # includes the key token

    slash_cum = np.concatenate(
        [[0], np.cumsum(data == ord("/"), dtype=np.int32)]
    )
    line_slashes = slash_cum[ends] - slash_cum[starts]

    m_face = line_tokens[f_lines] - 1  # corners per face
    s_face = np.where(m_face > 0, line_slashes[f_lines] // np.maximum(m_face, 1), 0)
    ok = (m_face >= 3) & (line_slashes[f_lines] == s_face * m_face) & (s_face <= 2)
    if (~ok & (m_face >= 3)).any():
        raise ValueError("inconsistent face vertex format in OBJ")

    # usemtl runs: material index per face line (-1 before the first usemtl)
    um_lines = np.asarray(usemtl_lines, np.int64)
    mat_of_face = (np.searchsorted(um_lines, f_lines, side="right") - 1).astype(
        np.int32
    )

    tri_v_parts, tri_t_parts, tri_face_parts, tri_order_parts = [], [], [], []
    for m in np.unique(m_face[ok]):
        for sc in np.unique(s_face[ok & (m_face == m)]):
            sel = np.flatnonzero(ok & (m_face == m) & (s_face == sc))
            lines = f_lines[sel]
            buf = _extract_lines(data, starts[lines], ends[lines], 1)
            if sc == 2:
                buf = buf.replace(b"//", b"/0/")
            if sc:
                buf = buf.replace(b"/", b" ")
            stride = int(sc) + 1
            cols = _token_table(buf, np.int64, m * stride, sel.size, "f")
            vi = cols[:, 0::stride]
            # resolve 1-based / negative indices
            vi = np.where(vi > 0, vi - 1, n_pos + vi)
            if sc >= 1:
                ti_raw = cols[:, 1::stride]
                ti = np.where(
                    ti_raw > 0, ti_raw - 1, np.where(ti_raw < 0, n_tc + ti_raw, -1)
                )
            else:
                ti = np.full_like(vi, -1)

            # fan triangulation (0, i, i+1), preserving file order
            n_f = sel.size
            fan = int(m) - 2
            t_v = np.empty((n_f, fan, 3), np.int64)
            t_v[:, :, 0] = vi[:, :1]
            t_v[:, :, 1] = vi[:, 1:-1]
            t_v[:, :, 2] = vi[:, 2:]
            t_t = np.empty((n_f, fan, 3), np.int64)
            t_t[:, :, 0] = ti[:, :1]
            t_t[:, :, 1] = ti[:, 1:-1]
            t_t[:, :, 2] = ti[:, 2:]
            tri_v_parts.append(t_v.reshape(-1, 3))
            tri_t_parts.append(t_t.reshape(-1, 3))
            tri_face_parts.append(np.repeat(sel.astype(np.int32), fan))
            order = lines[:, None].astype(np.int64) * (1 << 20) + np.arange(fan)[None, :]
            tri_order_parts.append(order.reshape(-1))

    if not tri_v_parts:
        return empty

    tri_v = np.concatenate(tri_v_parts)
    tri_t = np.concatenate(tri_t_parts)
    tri_face = np.concatenate(tri_face_parts)
    order = np.argsort(np.concatenate(tri_order_parts), kind="stable")
    tri_v, tri_t, tri_face = tri_v[order], tri_t[order], tri_face[order]
    tri_mat = mat_of_face[tri_face]
    return (
        positions, texcoords, tri_v, tri_t, tri_mat, tri_face,
        usemtl_names, mtllib_names,
    )


# --- per-line fallback parser ------------------------------------------------


def _resolve_index(idx: int, count: int) -> int:
    """OBJ indices are 1-based; negative values are relative to the end."""
    return idx - 1 if idx > 0 else count + idx


def _parse_obj_python(content: bytes):
    """Line-by-line parser for files the bulk parsers cannot handle."""
    positions: list[tuple] = []
    texcoords: list[tuple] = []
    tri_v: list[tuple] = []
    tri_t: list[tuple] = []
    tri_mat: list[int] = []
    tri_face: list[int] = []
    usemtl_names: list[str] = []
    mtllib_names: list[str] = []
    cur_mat = -1
    face_id = 0

    for raw in content.decode("utf-8", "replace").splitlines():
        if not raw or raw[0] == "#":
            continue
        parts = raw.split()
        if not parts:
            continue
        key = parts[0]
        if key == "v" and len(parts) >= 4:
            positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif key == "vt" and len(parts) >= 2:
            u = float(parts[1])
            v = float(parts[2]) if len(parts) > 2 else 0.0
            texcoords.append((u, v))
        elif key == "f":
            nv = len(positions)
            nt = len(texcoords)
            corners = []
            for tok in parts[1:]:
                comp = tok.split("/")
                vi = _resolve_index(int(comp[0]), nv)
                if len(comp) > 1 and comp[1]:
                    ti = _resolve_index(int(comp[1]), nt)
                else:
                    ti = -1
                corners.append((vi, ti))
            if len(corners) < 3:
                continue
            for i in range(1, len(corners) - 1):
                tri_v.append((corners[0][0], corners[i][0], corners[i + 1][0]))
                tri_t.append((corners[0][1], corners[i][1], corners[i + 1][1]))
                tri_mat.append(cur_mat)
                tri_face.append(face_id)
            face_id += 1
        elif key == "usemtl":
            usemtl_names.append(parts[1] if len(parts) > 1 else "")
            cur_mat += 1
        elif key == "mtllib":
            mtllib_names.extend(parts[1:])

    return (
        np.asarray(positions, np.float32).reshape(-1, 3),
        np.asarray(texcoords, np.float32).reshape(-1, 2),
        np.asarray(tri_v, np.int64).reshape(-1, 3),
        np.asarray(tri_t, np.int64).reshape(-1, 3),
        np.asarray(tri_mat, np.int32),
        np.asarray(tri_face, np.int32),
        usemtl_names,
        mtllib_names,
    )


# --- shared assembly ---------------------------------------------------------


def load_obj(path: str, default_texture_id: int = -1, pool: TexturePool | None = None):
    """Load an OBJ file.  Returns (TriangleSoup, TexturePool) or None on error."""
    if pool is None:
        pool = TexturePool()

    try:
        with open(path, "rb") as f:
            content = f.read()
    except OSError:
        log.error(f'Failed to open OBJ file: "{path}"')
        return None

    obj_dir = os.path.dirname(os.path.abspath(path))

    parsed = parse_obj_native(content)
    if parsed is None:
        try:
            parsed = _parse_obj_numpy(content)
        except ValueError:
            parsed = _parse_obj_python(content)
    (
        positions, texcoords, tri_v, tri_t, tri_mat, tri_face,
        usemtl_names, mtllib_names,
    ) = parsed

    n = tri_v.shape[0]
    if n == 0:
        return TriangleSoup.empty(), pool

    materials = _load_mtllibs(mtllib_names, obj_dir)
    tex_ids: dict[str, int] = {}

    def load_material_texture(name: str) -> int:
        if name in tex_ids:
            return tex_ids[name]
        sanitized = name.replace("\\", "/")
        candidates = [sanitized, os.path.join(obj_dir, sanitized)]
        img = None
        for cand in candidates:
            img = load_image(cand)
            if img is not None:
                break
        if img is None:
            log.warning(f'Failed to open texture file "{sanitized}"')
            tex_ids[name] = -1
            return -1
        tid = pool.add(img, UV_WRAP)
        tex_ids[name] = tid
        log.info(f'Loaded texture "{sanitized}"')
        return tid

    # reference semantics: a face "has UVs" only if every corner does
    n_faces = int(tri_face.max()) + 1 if n else 0
    face_all_uv = np.ones(n_faces, bool)
    np.logical_and.at(face_all_uv, tri_face, (tri_t >= 0).all(axis=1))
    tri_uvok = face_all_uv[tri_face]

    t_type = np.empty(n, np.int32)
    t_rgb = np.empty((n, 3), np.float32)
    t_tex = np.empty(n, np.int32)
    for mi in np.unique(tri_mat):
        msel = tri_mat == mi
        name = usemtl_names[mi] if 0 <= mi < len(usemtl_names) else None
        mtl = materials.get(name) if name is not None else None
        for uv_state in (False, True):
            sel = msel & (tri_uvok == uv_state)
            if not sel.any():
                continue
            if mtl is None:
                if uv_state and default_texture_id >= 0:
                    t, c, x = TRI_TEXTURED, (1.0, 1.0, 1.0), default_texture_id
                else:
                    t, c, x = TRI_MATERIALLESS, (1.0, 1.0, 1.0), -1
            elif uv_state and mtl["map_kd"]:
                tid = load_material_texture(mtl["map_kd"])
                if tid >= 0:
                    t, c, x = TRI_TEXTURED, (1.0, 1.0, 1.0), tid
                else:
                    t, c, x = TRI_UNTEXTURED, mtl["kd"], -1
            else:
                t, c, x = TRI_UNTEXTURED, mtl["kd"], -1
            t_type[sel] = t
            t_rgb[sel] = c
            t_tex[sel] = x

    n_pos = positions.shape[0]
    n_tc = texcoords.shape[0]
    verts = positions[np.clip(tri_v, 0, max(n_pos - 1, 0))]
    uvs = np.zeros((n, 3, 2), np.float32)
    if n_tc:
        valid = tri_t >= 0
        uvs[valid] = texcoords[np.clip(tri_t, 0, n_tc - 1)][valid]

    soup = TriangleSoup(
        verts=np.ascontiguousarray(verts, np.float32),
        uvs=uvs,
        types=t_type,
        rgb=t_rgb,
        tex=t_tex,
    )
    ntex = len([t for t in tex_ids.values() if t >= 0])
    log.info(f"Loaded {ntex} material textures")
    return soup, pool
