"""The batch's prep on the device (ops/batch_prep.batch_table) against the
numpy path it replaces in `voxelize_batch`: one `prepare_soup` a mesh, z
moved by i r_s in float32, the columns concatenated and `host_table`.  The
table's bytes and the host AABBs must be equal, bit for bit.

The cases marked `card` hold the same equality on CUDA; the JAX package is
not imported here, so they run where JAX is not installed:

    python -m pytest tests/test_torch_batch_prep.py -m card --noconftest
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from obj2voxel_tpu_torch import constants as C
from obj2voxel_tpu_torch import engine
from obj2voxel_tpu_torch.ops.batch_prep import batch_table
from obj2voxel_tpu_torch.soup import TriangleSoup
from obj2voxel_tpu_torch.utils.meshes import make_sphere_mesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _sphere_set(seed):
    """The benchmark's `spheres1000` traffic for `seed`: 1000 untextured
    spheres (224,626 triangles) with per-triangle colors, in model space."""
    from benchmark.inputs import sphere_set

    params = json.loads((ROOT / "benchmark/traffic/spheres1000.json").read_text())
    inputs = sphere_set.make(params["inputs"], 64, np.random.default_rng(seed), seed,
                             torch.device("cpu"))
    return [_soup(v, rgb=rgb, types=C.TRI_UNTEXTURED) for v, rgb in inputs.meshes]


def _config5():
    """BASELINE config 5 as `scale.config5` draws it: 1000 white spheres."""
    rng = np.random.RandomState(0)
    soups = []
    for _ in range(1000):
        n = int(rng.randint(50, 400))
        soups.append(TriangleSoup.from_vertices(
            make_sphere_mesh(n) * rng.uniform(0.5, 1.5)))
    return soups


def _soup(verts, uvs=None, types=C.TRI_MATERIALLESS, rgb=None, tex=None):
    n = verts.shape[0]
    return TriangleSoup(
        np.asarray(verts, np.float32),
        np.zeros((n, 3, 2), np.float32) if uvs is None else uvs.astype(np.float32),
        np.full(n, types, np.int32),
        np.ones((n, 3), np.float32) if rgb is None else rgb.astype(np.float32),
        np.full(n, -1, np.int32) if tex is None else tex.astype(np.int32))


def _random_soup(rng, n, spread, textured=False):
    """n triangles around random centres: with a large spread many are
    diagonal and big enough to subdivide over several rounds."""
    centres = rng.uniform(-1, 1, (n, 1, 3))
    verts = centres + rng.uniform(-spread, spread, (n, 3, 3))
    if not textured:
        return _soup(verts, rgb=rng.random((n, 3)), types=C.TRI_UNTEXTURED)
    return _soup(verts, uvs=rng.uniform(-1, 2, (n, 3, 2)), types=C.TRI_TEXTURED,
                 rgb=rng.random((n, 3)), tex=rng.integers(0, 3, n))


def _textured(rng):
    return [_random_soup(rng, n, s, textured=True)
            for n, s in ((40, 0.9), (1, 1.0), (300, 0.2), (7, 2.0))]


def _empty_edges(rng):
    empty = TriangleSoup.empty()
    return [empty, _random_soup(rng, 30, 0.8), empty, empty,
            _random_soup(rng, 5, 1.5, textured=True), empty]


def _flat(rng):
    # flat along z (every triangle axis-aligned), then along x with one
    # diagonal triangle among them
    verts = rng.uniform(-2, 2, (50, 3, 3))
    verts[:, :, 2] = 0.25
    flat_x = rng.uniform(-1, 1, (20, 3, 3))
    flat_x[:, :, 0] = -3.0
    return [_soup(verts), _soup(flat_x),
            _soup(np.concatenate([flat_x, [[[0, 0, 0], [1, 0, 1], [0, 1, 1]]]]))]


def _one_triangle(rng):
    diagonal = np.array([[[0, 0, 0], [1, 0, 1], [0, 1, 1]]], np.float32)
    return [_soup(diagonal), _random_soup(rng, 1, 1.0), _soup(diagonal * 3.0 + 1.0)]


def _boundary_triangles(rng, n):
    """(n, 3, 3) float32 triangles whose normals lie on the diagonality
    limit of `subdivide.roughly_axis_aligned` (|n|_1 / |n|_2 = 1 +
    (1 - 1/sqrt 3) / (2 / sqrt 3)), found in float64 by bisection between an
    axis and a random direction; float32 rounding puts about half on either
    side, so a sum in another order or a fused multiply-add moves some."""
    third = 1 / np.sqrt(3)
    target = 1 + 0.5 * (1 - third) / third
    normal = rng.normal(size=(n, 3))
    axis = np.zeros((n, 3))
    big = np.abs(normal).argmax(1)
    axis[np.arange(n), big] = np.sign(normal[np.arange(n), big])
    lo, hi = np.zeros((n, 1)), np.ones((n, 1))
    for _ in range(60):
        mid = (lo + hi) / 2
        v = axis * (1 - mid) + normal * mid
        over = (np.abs(v).sum(1) / np.linalg.norm(v, axis=1) > target)[:, None]
        lo, hi = np.where(over, lo, mid), np.where(over, mid, hi)
    v = axis * (1 - lo) + normal * lo
    e1 = np.cross(v, np.where(np.abs(v[:, :1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]]))
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(v, e1)
    size = rng.uniform(10, 40, (n, 1))
    v0 = rng.uniform(0, 20, (n, 3))
    return np.stack([v0, v0 + e1 * size, v0 + e2 * size], 1).astype(np.float32)


#: each case: (soups, sample resolution r_s = resolution * supersampling)
CASES = {
    "spheres1000_seed_a": (lambda: _sphere_set(4100000001), 64),
    "spheres1000_seed_b": (lambda: _sphere_set(2**31 + 12345), 64),
    "textured": (lambda: _textured(np.random.default_rng(1)), 32),
    "empty_start_middle_end": (lambda: _empty_edges(np.random.default_rng(2)), 16),
    "flat_along_an_axis": (lambda: _flat(np.random.default_rng(3)), 64),
    "one_triangle": (lambda: _one_triangle(np.random.default_rng(4)), 64),
    "supersampling_2": (lambda: _textured(np.random.default_rng(5)), 2 * 16),
    "diagonality_limit": (lambda: [_soup(_boundary_triangles(np.random.default_rng(8),
                                                             n)) for n in (3000, 500)], 64),
}


def _reference(soups, sample_res):
    """`voxelize_batch`'s numpy path: (table, (vmin, vmax), triangles out)."""
    parts = []
    for i, soup in enumerate(soups):
        if len(soup) == 0:
            continue
        verts, *rest = engine.prepare_soup(soup, sample_res)
        verts = verts.copy()
        verts[:, :, 2] += np.float32(i * sample_res)
        parts.append((verts, *rest))
    columns = [np.concatenate(c) for c in zip(*parts)]
    table, aabb = engine.host_table(*columns, stride=sample_res,
                                    z_extent=len(soups) * sample_res)
    return table, aabb, columns[0].shape[0]


def _assert_equal_prep(soups, sample_res, device):
    table, (vmin, vmax), stats = batch_table(soups, sample_res, device)
    want, (want_min, want_max), n_out = _reference(soups, sample_res)
    assert table.device.type == torch.device(device).type
    assert table.dtype == torch.float32 and table.shape == want.shape
    got = table.cpu().numpy()
    diff = np.flatnonzero((got.view(np.uint32) != want.view(np.uint32)).any(1))
    assert diff.size == 0, f"{diff.size} rows differ, first {diff[:5]}"
    for g, w in ((vmin, want_min), (vmax, want_max)):
        assert g.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert stats["triangles_out"] == n_out
    assert stats["triangles_in"] == sum(len(s) for s in soups)
    assert stats["meshes"] == sum(1 for s in soups if len(s))
    return stats


@pytest.mark.parametrize("case", list(CASES))
def test_batch_table_matches_the_numpy_prep(case):
    make, sample_res = CASES[case]
    stats = _assert_equal_prep(make(), sample_res, "cpu")
    if case.startswith("spheres1000"):
        # the cell's batch: two splitting rounds, the third check finds none
        assert stats["meshes"] == 1000 and stats["triangles_in"] == 224_626
        assert stats["rounds"] == 3
        assert 669_000 < stats["triangles_out"] < 669_700
    if case == "one_triangle":
        assert stats["triangles_out"] > 3


def test_axis_alignment_matches_numpy_on_the_limit():
    from obj2voxel_tpu_torch.ops.batch_prep import _roughly_axis_aligned
    from obj2voxel_tpu_torch.ops.subdivide import roughly_axis_aligned

    tri = _boundary_triangles(np.random.default_rng(9), 20_000)
    want = roughly_axis_aligned(tri)
    assert 0.2 < want.mean() < 0.8  # both sides of the limit
    np.testing.assert_array_equal(_roughly_axis_aligned(torch.from_numpy(tri)).numpy(),
                                  want)


def test_batch_table_of_only_empty_soups():
    assert batch_table([TriangleSoup.empty()] * 3, 16, "cpu") is None
    assert batch_table([], 16, "cpu") is None


def test_voxelize_batch_resets_and_fills_prep_stats():
    rng = np.random.default_rng(6)
    soups = [TriangleSoup.empty(), _random_soup(rng, 12, 0.6)]
    results = engine.voxelize_batch(soups, resolution=8, device="cpu")
    assert [x.shape[0] > 0 for x, _ in results] == [False, True]
    assert engine.PREP_STATS["meshes"] == 1
    assert engine.PREP_STATS["triangles_in"] == 12
    assert engine.PREP_STATS["triangles_out"] >= 12
    assert engine.PREP_STATS["rounds"] >= 1
    assert engine.PREP_STATS["device"] == "cpu"
    engine.voxelize_batch([TriangleSoup.empty()], resolution=8, device="cpu")
    assert engine.PREP_STATS == {"meshes": 0, "triangles_in": 0, "triangles_out": 0,
                                 "rounds": 0, "device": "cpu"}


def test_batch_table_records_the_debug_stl(tmp_path):
    from obj2voxel_tpu_torch.io import debug_stl

    soups = _empty_edges(np.random.default_rng(7))
    want = np.concatenate([engine.prepare_soup(s, 16)[0] for s in soups if len(s)])
    debug_stl.enable(str(tmp_path / "dump.stl"))
    try:
        batch_table(soups, 16, "cpu")
        got = np.concatenate(debug_stl._buffers)
    finally:
        debug_stl.flush()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("case", ["config5", "spheres1000_seed_a", "textured",
                                  "empty_start_middle_end", "supersampling_2",
                                  "diagonality_limit"])
def test_batch_table_matches_the_numpy_prep_on_card(card, case):
    if case == "config5":
        stats = _assert_equal_prep(_config5(), 64, card)
        assert stats == {"meshes": 1000, "triangles_in": 224_626,
                         "triangles_out": 669_310, "rounds": 3}
        return
    make, sample_res = CASES[case]
    _assert_equal_prep(make(), sample_res, card)
