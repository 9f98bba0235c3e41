"""K1's textured variant and the textured pass built on it, on the CPU.

- The plain version (`fused_pass(textured=True)` on CPU tensors) against the
  JAX package's `fused_pass_pallas(textured=True, interpret=True)` at its
  smallest budget.  XLA compiles the interpret-mode kernel for the CPU (some
  40 s a variant, so only the clipped-area variant runs there) and
  contracts multiply-adds into FMAs, so the tolerances are those of
  tests/test_torch_clip_pairs.py: the same occupancy above 1e-6, w to rtol
  1e-5 with atol 1e-6, u and v of occupied pairs to rtol 1e-5 with atol
  1e-4.  The JAX kernel writes every slot, the port its live pairs
  compacted in slot order; the live pairs are compared by (row, key) and in
  slot order, which a stable key sort (as in tests/test_torch_clip.py)
  would keep.
- The same, with and without `ref_weights`, against the JAX package's clip
  and triangle area run op by op (`jax.disable_jit()`), the same float32
  operations in the same order: keys, rows, w, u and v exactly.
- `ref_weights` keeps the clipped variant's pairs, order and UVs, and
  weighs each by its whole triangle's area.
- K1's textured variant, then `engine._textured_pass` on its live pairs,
  against the route they replaced (`pass_pairs` -> the plain K4 -> texture
  sampling -> K3), byte for byte.
- A stream reads nothing of a pass past its count: with every row past each
  count poisoned (keys in range, NaN channels, row ids outside the table),
  a textured and an untextured soup give the bytes of the clean run.

The JAX outputs are those of tests/fixtures/jax_fused_textured.npz
(scripts/jax_test_references.py).

The tables hold triangles of mixed sizes with a quarter of their
coordinates on voxel planes, triangles in or within 1e-5 of a voxel face,
and a triangle in the plane x = 6, which belongs to the voxel above it.
"""

import sys

import numpy as np
import pytest
import torch

from jax_reference import reference
import obj2voxel_tpu_torch as pt
from obj2voxel_tpu_torch import constants as C
from obj2voxel_tpu_torch import engine
from obj2voxel_tpu_torch.ops import _cuda, pass_fused
from obj2voxel_tpu_torch.ops.clip_pallas import clip_pairs_ref, pass_pairs
from obj2voxel_tpu_torch.ops.color import sample_pair_colors_uv, upload_pool
from obj2voxel_tpu_torch.ops.combine import premultiply
from obj2voxel_tpu_torch.ops.pack_pallas import pack_exact
from obj2voxel_tpu_torch.ops.pass_fused import (
    fused_pass, fused_pass_ref, triangle_area,
)
from obj2voxel_tpu_torch.soup import build_tri_table

torch.set_num_threads(1)

INV = (1 << 31) - 1
#: the JAX kernel's block (SUB x 128 slots): its smallest budget
BUDGET = 8192
EXPAND = 8
RES = 32
Z_LO, Z_HI = 2, 30


def _arrays(seed, n=1100, res=RES):
    """Host arrays (verts, uvs, types, rgb, tex) of n textured triangles in
    voxel space: random triangles of three sizes (a quarter of their
    coordinates snapped onto voxel planes), then the triangle in the plane
    x = 6, then triangles in or within 1e-5 of a voxel face; UVs in [-2, 3],
    three textures and some flat rows."""
    rng = np.random.default_rng(seed)
    n_face = n // 3
    n_rand = n - n_face - 1
    base = rng.uniform(1, res - 3, size=(n_rand, 1, 3))
    size = rng.choice([0.8, 1.6, 2.4], size=(n_rand, 1, 1))
    verts = base + rng.uniform(0, 1, size=(n_rand, 3, 3)) * size
    verts = np.where(rng.random(verts.shape) < 0.25, np.round(verts), verts)
    vox = rng.integers(1, res - 2, size=(n_face, 3)).astype(np.float64)
    face = vox[:, None, :] + rng.uniform(0, 1, size=(n_face, 3, 3))
    axis = rng.integers(0, 3, size=n_face)
    offset = rng.choice([0.0, 1.0, 1e-5, -1e-5, 1 + 1e-5, 1 - 1e-5, 2 ** -16],
                        size=n_face)
    face[np.arange(n_face), :, axis] = (vox[np.arange(n_face), axis] + offset)[:, None]
    edge = np.array([[[6.0, 5.2, 5.2], [6.0, 5.8, 5.2], [6.0, 5.2, 5.8]]])
    verts = np.concatenate([verts, edge, face]).astype(np.float32)
    uvs = rng.uniform(-2, 3, size=(n, 3, 2)).astype(np.float32)
    types = np.where(rng.random(n) < 0.8, C.TRI_TEXTURED, C.TRI_UNTEXTURED)
    tex = np.where(types == C.TRI_TEXTURED, rng.integers(0, 3, n), -1)
    return (verts, uvs, types.astype(np.int32),
            rng.random((n, 3), dtype=np.float32), tex.astype(np.int32))


def _table(seed, n=1100, res=RES):
    """`_arrays` as (n, 24) table rows."""
    return build_tri_table(*_arrays(seed, n, res))


def _pool():
    """Three textures, CLAMP and REPEAT, odd sizes (the port's pool on the
    CPU)."""
    rng = np.random.default_rng(21)
    pool = pt.TexturePool()
    for i, (h, w) in enumerate([(3, 5), (64, 17), (129, 31)]):
        img = (0xFF000000 | rng.integers(0, 1 << 24, (h, w))).astype(np.uint32)
        pool.add(img, C.UV_CLAMP if i % 2 else C.UV_WRAP)
    return upload_pool(pool, "cpu")


@pytest.fixture(scope="module")
def table():
    return _table(5)


#: the interpret-mode comparison's grid: XLA's contracted multiply-adds err
#: by about an ulp of the coordinates, which an edge-plane intersection
#: near a vertex magnifies; below 8, as in tests/test_torch_clip_pairs.py,
#: that stays inside the tolerances, while at 32 it moved weights by up to
#: 1.6e-4 relative on rows with snapped coordinates (the op-by-op
#: comparison holds the 32^3 table exactly)
SMALL = (0, 8, 8)


@pytest.fixture(scope="module")
def small_table():
    return _table(6, res=SMALL[2])


def _port(table, r0, n_rows, ref_weights, grid=(Z_LO, Z_HI, RES)):
    """The plain K1 textured pass over rows [r0, r0 + n_rows) at BUDGET on
    the grid (z_lo, z_hi, stride): (key, w, u, v, row) of its live pairs, in
    slot order."""
    out = fused_pass(torch.from_numpy(table), r0, n_rows, 0, *grid,
                     expand=EXPAND, budget=BUDGET, ref_weights=ref_weights,
                     textured=True)
    n = int(out[5])
    assert out[4].dtype == torch.int32
    assert bool((out[0][n:] == INV).all())
    assert all(bool((c[n:] == 0).all()) for c in out[1:5])
    return [x[:n].numpy() for x in out[:5]]


R0, N_ROWS = 40, BUDGET // EXPAND


def _pairs(key, w, u, v, row):
    """{(row, key): (w, u, v)} of live pairs, in slot order."""
    return {(int(r), int(k)): (float(a), float(b), float(c))
            for k, a, b, c, r in zip(key, w, u, v, row)}


def test_plain_matches_pallas_interpret(small_table):
    # occupancy is the clipped area's: every pair whose clipped area passes
    # 1e-6 on either side is live on both, in the same slot order, which a
    # stable key sort would keep; FMA contraction moves slivers below that
    # across 0
    table = small_table
    rows = table[R0:R0 + N_ROWS]
    ref = reference("fused_textured", "pallas_interpret", rows, grid=SMALL,
                    n_rows=N_ROWS, expand=EXPAND, budget=BUDGET)
    key, w, u, v, zero = (ref[k] for k in ("key", "w", "u", "v", "zero"))
    np.testing.assert_array_equal(zero, 0.0)
    live = key != INV
    row = R0 + np.arange(BUDGET) // EXPAND
    want = _pairs(key[live], w[live], u[live], v[live], row[live])
    got = _pairs(*_port(table, R0, N_ROWS, False, SMALL))
    occupied = {p for side in (want, got) for p, x in side.items() if x[0] > 1e-6}
    assert len(occupied) > 2000
    order = [p for p in got if p in occupied]
    assert order == [p for p in want if p in occupied]
    g = np.array([got[p] for p in order])
    x = np.array([want[p] for p in order])
    np.testing.assert_allclose(g[:, 0], x[:, 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g[:, 1:], x[:, 1:], rtol=1e-5, atol=1e-4)


def test_ref_weights_keeps_clipped_pairs(table):
    # the same live pairs in the same order with the same UVs; w is the
    # whole triangle's area of the pair's row
    key, w, u, v, row = _port(table, R0, N_ROWS, False)
    rkey, rw, ru, rv, rrow = _port(table, R0, N_ROWS, True)
    for a, b in ((key, rkey), (u, ru), (v, rv), (row, rrow)):
        np.testing.assert_array_equal(a, b)
    area = triangle_area(torch.from_numpy(table[:, 0:16].T.copy())).numpy()
    np.testing.assert_array_equal(rw, area[row])
    assert (w > 0).all() and (w <= rw * (1 + 1e-5)).all()


def clip_inputs(table):
    """The op-by-op comparison's live slots: (row, voxel) and the clip's
    channel-major inputs (tri, vox4)."""
    rows = table[R0:R0 + N_ROWS]
    row, vox, inside = _slot_voxels(rows, Z_LO, Z_HI, RES, EXPAND)
    row, vox = row[inside], vox[inside]
    tri = np.ascontiguousarray(rows[row, 0:16].T)
    vox4 = np.zeros((4, row.size), np.float32)
    vox4[:3] = vox.T
    return row, vox, tri, vox4


def _slot_voxels(rows, z_lo, z_hi, stride, expand):
    """Every slot's (row, voxel, in its AABB) by exact integer arithmetic:
    the planner's AABB, rank = slot & (expand - 1)."""
    v = rows[:, 0:9].reshape(-1, 3, 3).astype(np.float32)
    lo = np.array([0, 0, z_lo])
    hi = np.array([stride, stride, z_hi])
    t_lo = np.clip(np.floor(v.min(axis=1)).astype(np.int64), lo, hi)
    t_hi = np.clip(np.floor(v.max(axis=1)).astype(np.int64) + 1, lo, hi)
    size = np.maximum(t_hi - t_lo, 0)
    slot = np.arange(rows.shape[0] * expand)
    row, local = slot // expand, slot % expand
    sx, sy = np.maximum(size[row, 0], 1), np.maximum(size[row, 1], 1)
    vox = t_lo[row] + np.stack([local % sx, (local // sx) % sy, local // sx // sy], 1)
    return row, vox, local < size[row].prod(axis=1)


@pytest.mark.parametrize("ref_weights", [False, True], ids=["clipped", "ref_weights"])
def test_plain_matches_op_by_op_clip_exactly(table, ref_weights):
    r0, n_rows = R0, N_ROWS
    row, vox, tri, vox4 = clip_inputs(table)
    # the JAX clip, and with ref_weights the triangle area of
    # obj2voxel_tpu/ops/pass_fused.py:191-197, op by op
    ref = reference("fused_textured", "clip_channels", tri, vox4)
    w, u, v = ref["w"], ref["u"], ref["v"]
    if ref_weights:
        w = np.where(w > 0, ref["area"], np.float32(0))
    live = w > 0
    key = ((vox[:, 2] - Z_LO) * RES * RES + vox[:, 1] * RES + vox[:, 0])
    # both in slot order
    want = [key[live].astype(np.int32), w[live], u[live], v[live],
            (r0 + row[live]).astype(np.int32)]
    got = _port(table, r0, n_rows, ref_weights)
    assert want[0].size > 500 and (~live).sum() > 500
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


def _old_textured_pass(table, pool, r0, n_rows, local_base, z_lo, z_hi, stride,
                       *, expand, budget, wide_local, ref_weights=False):
    """The textured pass as it was: the slots expanded in torch ops, every
    pair clipped (the plain K4), sampled, and compacted (the plain K3)."""
    tri, vox, attrs, (vx, vy, vz), valid = pass_pairs(
        table.T.contiguous(), r0, n_rows, local_base, z_lo, z_hi, stride,
        expand=expand, budget=budget, wide_local=wide_local)
    out = clip_pairs_ref(tri, vox)
    w = torch.where(valid, out[0], 0.0)
    if ref_weights:
        w = torch.where(w > 0, triangle_area(tri), 0.0)
    colors = sample_pair_colors_uv(
        out[1], out[2], attrs[0].to(torch.int64), attrs[1:4].T,
        attrs[4].to(torch.int64), *pool)
    key = (vz - z_lo) * (stride * stride) + vy * stride + vx
    key = torch.where(w > 0, key, INV).to(torch.int32)
    k, chans, count = pack_exact(key, premultiply(w, colors))
    return (k, *chans, count)


def _giant():
    """One textured triangle whose AABB (64 x 64 x 3) is wider than the
    pass: its passes walk the slot domain with the integer rank decode."""
    verts = np.array([[[0.5, 0.5, 0.5], [63.5, 0.5, 2.5], [0.5, 63.5, 2.5]]],
                     np.float32)
    uvs = np.array([[[-0.3, 0.1], [2.2, -0.4], [0.4, 1.9]]], np.float32)
    return build_tri_table(verts, uvs, np.full(1, C.TRI_TEXTURED, np.int32),
                                np.full((1, 3), 0.5, np.float32),
                                np.zeros(1, np.int32))


@pytest.mark.parametrize("ref_weights", [False, True], ids=["clipped", "ref_weights"])
@pytest.mark.parametrize("case", ["expand8", "expand1-faces", "wide_local"])
def test_textured_pass_equals_old_route_bytes(table, case, ref_weights):
    if case == "wide_local":
        t = _giant()
        args = (0, 1, 4096, 0, 64, 64)
        kw = dict(expand=4096, budget=4096, wide_local=True)
    elif case == "expand1-faces":
        # the x = 6 triangle and the face-grazing rows, one slot a row
        t = table
        args = (700, 400, 0, Z_LO, Z_HI, RES)
        kw = dict(expand=1, budget=1024, wide_local=False)
    else:
        t = table
        args = (R0, N_ROWS, 0, Z_LO, Z_HI, RES)
        kw = dict(expand=EXPAND, budget=BUDGET, wide_local=False)
    t, pool = torch.from_numpy(t), _pool()
    key, *chans, count = fused_pass(t, *args, ref_weights=ref_weights,
                                    textured=True, **kw)
    n = int(count)
    got = (key[:n], *engine._textured_pass(t, pool, *(x[:n] for x in chans)))
    want = _old_textured_pass(t, pool, *args, ref_weights=ref_weights, **kw)
    assert int(want[5]) == n > 100
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and g.shape == x[:n].shape
        assert torch.equal(g.view(torch.int32), x[:n].view(torch.int32))


def test_wrapper_takes_plain_version_on_cpu(table):
    args = (torch.from_numpy(table), 0, 100, 0, Z_LO, Z_HI, RES)
    got = fused_pass(*args, expand=8, budget=1024, ref_weights=True, textured=True)
    want = fused_pass_ref(*args, expand=8, budget=1024, wide_local=False,
                          ref_weights=True, textured=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _stream_bytes(arrays, pool, **kw):
    """The voxels of one CPU stream of host `arrays` on the RES^3 grid, MAX,
    as bytes."""
    out = engine.voxelize_grid(*arrays, pool, device="cpu", stride=RES,
                               z_extent=RES, is_blend=False, **kw)
    return b"".join(x.tobytes() + a.tobytes() for x, a in out)


def test_textured_pass_runs_k1_textured(monkeypatch):
    # a textured mesh's passes go to K1 with textured=True, and each pass's
    # live pairs, and only those, to `_textured_pass`
    calls, colored = [], []
    inner, color = engine.fused_pass, engine._textured_pass

    def logged(*args, **kw):
        out = inner(*args, **kw)
        calls.append((kw["textured"], int(out[5])))
        return out

    def logged_color(table, pool, w, u, v, row):
        colored.append(w.shape[0])
        return color(table, pool, w, u, v, row)

    monkeypatch.setattr(engine, "fused_pass", logged)
    monkeypatch.setattr(engine, "_textured_pass", logged_color)
    assert _stream_bytes(_arrays(7, n=300), _pool(), max_pass_budget=1 << 14)
    assert len(calls) > 1 and all(textured for textured, _ in calls)
    assert colored == [n for _, n in calls if n]


@pytest.mark.parametrize("textured", [False, True], ids=["untextured", "textured"])
def test_stream_reads_nothing_past_a_count(monkeypatch, textured):
    arrays = _arrays(8, n=300)
    pool = _pool() if textured else None
    kw = dict(max_pass_budget=1 << 14)
    want = _stream_bytes(arrays, pool, **kw)
    clean = pass_fused.fused_pass_ref
    poisoned = []

    def poison(table, *args, budget, **kw):
        out = clean(table, *args, budget=budget, **kw)
        n = int(out[5])
        gen = torch.Generator().manual_seed(len(poisoned))
        out[0][n:] = torch.randint(0, RES ** 3, (budget - n,), generator=gen,
                                   dtype=torch.int32)
        for c in out[1:5]:
            if c.dtype == torch.int32:  # the rows: ids outside the table
                c[n:] = table.shape[0] + torch.randint(
                    0, 1 << 20, (budget - n,), generator=gen, dtype=torch.int32)
            else:
                c[n:] = float("nan")
        poisoned.append(budget - n)
        return out

    monkeypatch.setattr(pass_fused, "fused_pass_ref", poison)
    assert _stream_bytes(arrays, pool, **kw) == want
    assert len(poisoned) > 1 and sum(poisoned) > 0


@pytest.mark.parametrize("wide_local", [False, True], ids=["slots", "wide_local"])
def test_wrapper_textured_layout(monkeypatch, wide_local):
    # the CUDA branch on meta tensors with a stand-in library: one call of
    # the one launcher for one pass, with textured=1 and wide_local passed
    # through, one allocation, and the fourth channel is the rows' int32
    calls, made = [], []

    class Lib:
        def o2v_fused_pass(self, *args):
            calls.append(args)
            return 0

    empty = torch.empty

    def tracked_empty(*size, **kw):
        made.append(empty(*size, **kw))
        return made[-1]

    monkeypatch.setattr(_cuda, "lib", Lib)
    monkeypatch.setattr(_cuda, "require_cuda", lambda name, *t: t[0].device)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda dev: 0)
    table = torch.zeros((64, 24), device="meta")
    monkeypatch.setattr(torch, "empty", tracked_empty)
    _cuda.reset_launches()
    budget = 1024
    key, w, u, v, row, count = fused_pass(table, 0, 64, 0, 0, 8, 8, expand=8,
                                          budget=budget, wide_local=wide_local,
                                          textured=True)
    assert _cuda.LAUNCHES["fused_pass"] == len(calls) == 1
    assert len(made) == 1
    assert key.dtype == row.dtype == count.dtype == torch.int32
    assert w.dtype == u.dtype == v.dtype == torch.float32
    assert key.shape == row.shape == (budget,) and count.shape == (1,)
    # outputs at the pointers passed (a meta tensor's pointer is 0)
    assert list(calls[0][:6]) == [4 * i * budget for i in range(6)]
    offsets = [4 * x.storage_offset() for x in (key, w, u, v, row, count)]
    assert offsets == list(calls[0][:6])
    # one pass, stride 8, log2 expand 3, budget, wide_local, ref_weights,
    # textured
    assert calls[0][10:17] == (1, 8, 3, budget, int(wide_local), 0, 1)
    fused_pass(table, 0, 64, 0, 0, 8, 8, expand=8, budget=budget)
    assert calls[1][14:17] == (0, 0, 0)


def _fake_nvcc(tmp_path, monkeypatch, fail_on=None):
    """Point the build at a stand-in nvcc that writes its -o file and prints
    a ptxas line naming its source (or fails on the source `fail_on`), and
    at a build directory under tmp_path; returns the file of its calls."""
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"FAIL = {fail_on!r}\n"
        "args = sys.argv[1:]\n"
        f"open({str(calls)!r}, 'a').write(' '.join(args) + '\\n')\n"
        "if FAIL and args[-1].endswith(FAIL):\n"
        "    print('error: no such kernel'); sys.exit(2)\n"
        "open(args[args.index('-o') + 1], 'w').write('obj')\n"
        "if '-c' in args:\n"
        "    print('ptxas info    : Used 8 registers for', args[-1].split('/')[-1])\n"
    )
    nvcc.chmod(0o755)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    return calls


def test_build_logs_resource_usage_per_source(tmp_path, monkeypatch):
    calls = _fake_nvcc(tmp_path, monkeypatch)
    so = _cuda.build()
    sources = sorted(_cuda.CSRC.glob("*.cu"))
    assert so.exists() and so.parent == tmp_path / "build"
    log = _cuda.resource_log_path().read_text()
    for src in sources:
        assert f"== {src.name}\nptxas info    : Used 8 registers for {src.name}" in log
    compiles = [c for c in calls.read_text().splitlines() if " -c " in c]
    assert len(compiles) == len(sources)
    assert all("--resource-usage" in c for c in compiles)
    # no objects left behind; a second call finds the library and runs no nvcc
    assert sorted(p.name for p in so.parent.iterdir()) == sorted(
        [so.name, _cuda.resource_log_path().name])
    n_calls = len(calls.read_text().splitlines())
    assert _cuda.build() == so
    assert len(calls.read_text().splitlines()) == n_calls


def test_build_raises_when_nvcc_fails(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, fail_on="fused_pass.cu")
    with pytest.raises(RuntimeError, match="(?s)fused_pass.o: nvcc failed.*no such kernel"):
        _cuda.build()
    assert list((tmp_path / "build").iterdir()) == []
