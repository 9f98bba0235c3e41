"""Batch mode: obj2voxel_tpu_torch.voxelize_batch(device="cpu") against the
JAX package's voxelize_batch on one mixed batch.

Parity contract (PARITY.md "Fidelity scope"): the voxel set of each mesh
exactly, MAX colors byte for byte, BLEND colors within 1 LSB per channel;
densify exactly; the cubes' closed form exactly.  The JAX reference ran op
by op (`jax.disable_jit()`), once per strategy; tests/fixtures/jax_batch.npz
holds its outputs (scripts/jax_test_references.py).
"""

import numpy as np
import pytest
import torch

from conftest import (
    UNIT_CUBE_QUADS, UNIT_CUBE_VERTICES, expected_unit_cube_voxels, quads_to_tris,
)
from jax_reference import reference
from obj2voxel_tpu import engine as jeng
import obj2voxel_tpu_torch as pt
from obj2voxel_tpu_torch import constants as C

torch.set_num_threads(1)

TILE = 1 << 14
CUBE = quads_to_tris(UNIT_CUBE_VERTICES, UNIT_CUBE_QUADS)
SCALES = (1.0, 2.0, 0.5, 7.0)
#: each case: (resolution, supersampling, strategy)
CASES = {
    "max": (16, 1, C.MAX_STRATEGY),
    "blend_ss2": (8, 2, C.BLEND_STRATEGY),
}


def _arrays(seed=0):
    """The mixed batch as arrays: four cubes at different scales, an empty
    mesh, a random colored soup, and a cube textured from a 3x5 REPEAT
    texture (so the pool holds more than one pixel)."""
    rng = np.random.default_rng(seed)
    meshes = []
    for s in SCALES:
        n = CUBE.shape[0]
        meshes.append((CUBE * np.float32(s), np.zeros((n, 3, 2), np.float32),
                       np.full(n, C.TRI_MATERIALLESS, np.int32),
                       np.ones((n, 3), np.float32), np.full(n, -1, np.int32)))
    meshes.append(None)
    n = 60
    centers = rng.random((n, 1, 3), dtype=np.float32)
    meshes.append(((centers + rng.uniform(-0.08, 0.08, (n, 3, 3))).astype(np.float32),
                   np.zeros((n, 3, 2), np.float32), np.full(n, C.TRI_UNTEXTURED, np.int32),
                   rng.random((n, 3), dtype=np.float32), np.full(n, -1, np.int32)))
    n = CUBE.shape[0]
    meshes.append((CUBE + np.float32(3.0), rng.uniform(-1, 2, (n, 3, 2)).astype(np.float32),
                   np.full(n, C.TRI_TEXTURED, np.int32), np.ones((n, 3), np.float32),
                   np.zeros(n, np.int32)))
    texture = (0xFF000000 | rng.integers(0, 1 << 24, (3, 5))).astype(np.uint32)
    return meshes, texture


def flat_arrays(meshes, texture):
    """Every input array of the batch, an empty mesh as an empty array."""
    return [a for m in meshes for a in (m or (np.zeros(0, np.float32),))] + [texture]


def _batch(pkg_soup, pkg_pool):
    meshes, texture = _arrays()
    soups = [pkg_soup.empty() if m is None else pkg_soup(*m) for m in meshes]
    pool = pkg_pool()
    pool.add(texture, C.UV_WRAP)
    return soups, pool


def _as_dicts(results):
    out = []
    for xyz, argb in results:
        assert xyz.dtype == np.int32 and argb.dtype == np.uint32
        d = {tuple(p): c for p, c in zip(xyz.tolist(), argb.tolist())}
        assert len(d) == xyz.shape[0], "duplicate voxel"
        out.append(d)
    return out


def _max_lsb(a, b):
    keys = list(a)
    x = np.array([a[k] for k in keys], np.uint32).view(np.uint8).astype(np.int16)
    y = np.array([b[k] for k in keys], np.uint32).view(np.uint8).astype(np.int16)
    return int(np.abs(x - y).max()) if keys else 0


@pytest.fixture(scope="module")
def jax_batches():
    """The JAX package's `voxelize_batch` of each case: (xyz, argb) a mesh."""
    meshes, texture = _arrays()
    refs = {}
    for name, (r, ss, strategy) in CASES.items():
        ref = reference("batch", name, *flat_arrays(meshes, texture), resolution=r,
                        supersampling=ss, strategy=strategy, pair_tile=TILE)
        refs[name] = [(ref[f"m{i}_xyz"].astype(np.int32), ref[f"m{i}_argb"])
                      for i in range(len(meshes))]
    return refs


@pytest.fixture(scope="module")
def port_batches():
    soups, pool = _batch(pt.TriangleSoup, pt.TexturePool)
    return {name: pt.voxelize_batch(soups, pool, resolution=r, device="cpu",
                                    supersampling=ss, strategy=strategy,
                                    pair_tile=TILE)
            for name, (r, ss, strategy) in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_mixed_batch_matches_jax(jax_batches, port_batches, case):
    port, ref = port_batches[case], jax_batches[case]
    assert len(port) == len(ref) == 7
    blend = CASES[case][2] == C.BLEND_STRATEGY
    for i, (got, want) in enumerate(zip(_as_dicts(port), _as_dicts(ref))):
        assert set(got) == set(want), f"mesh {i}"
        assert _max_lsb(got, want) <= (1 if blend else 0), f"mesh {i}"


@pytest.mark.parametrize("case", list(CASES))
def test_mixed_batch_keeps_stream_order(jax_batches, port_batches, case):
    # each mesh's rows in the JAX package's order, z mesh-local
    r = CASES[case][0]
    for (xyz, _), (ref_xyz, _) in zip(port_batches[case], jax_batches[case]):
        np.testing.assert_array_equal(xyz, ref_xyz)
        assert xyz.size == 0 or (xyz.min() >= 0 and xyz.max() < r)


def test_cubes_give_the_closed_form(port_batches):
    results = port_batches["max"]
    want = expected_unit_cube_voxels(16)
    for xyz, argb in results[: len(SCALES)]:
        assert xyz.shape[0] == want
        assert set(argb.tolist()) == {0xFFFFFFFF}
    assert results[len(SCALES)][0].shape == (0, 3)
    assert len(results[-1][0]) == want  # the textured cube


def test_textured_cube_samples_its_texture(port_batches):
    _, texture = _arrays()
    allowed = set(texture.ravel().tolist())
    xyz, argb = port_batches["max"][-1]
    assert set(argb.tolist()) <= allowed and len(set(argb.tolist())) > 1


def test_densify_matches_jax(port_batches):
    for xyz, argb in port_batches["max"]:
        np.testing.assert_array_equal(pt.densify(xyz, argb, 16),
                                      jeng.densify(xyz, argb, 16))
    xyz = np.array([[0, 0, 0], [3, 2, 1]], np.int32)
    argb = np.array([0xFF112233, 0xFFAABBCC], np.uint32)
    grid = pt.densify(xyz, argb, 4)
    np.testing.assert_array_equal(grid, jeng.densify(xyz, argb, 4))
    assert grid[3, 2, 1] == 0xFFAABBCC and (grid != 0).sum() == 2


def test_all_empty_and_no_meshes():
    empty = pt.TriangleSoup.empty()
    results = pt.voxelize_batch([empty, empty], resolution=8, device="cpu")
    assert len(results) == 2
    for xyz, argb in results:
        assert xyz.shape == (0, 3) and xyz.dtype == np.int32
        assert argb.shape == (0,) and argb.dtype == np.uint32
    assert pt.voxelize_batch([], resolution=8, device="cpu") == []


def test_split_by_mesh_cuts_the_z_ordered_stream():
    from obj2voxel_tpu_torch.engine import split_by_mesh

    xyz = np.array([[1, 2, 3], [0, 0, 7], [5, 5, 17], [4, 4, 30], [0, 1, 31]],
                   np.int32)
    argb = np.arange(5, dtype=np.uint32)
    batches = [(xyz[:2], argb[:2]), (xyz[2:], argb[2:])]
    parts = split_by_mesh(batches, 4, 8)  # mesh 1 has no voxel
    assert [p[0].shape[0] for p in parts] == [2, 0, 1, 2]
    np.testing.assert_array_equal(parts[3][0], [[4, 4, 6], [0, 1, 7]])
    np.testing.assert_array_equal(parts[3][1], [3, 4])
    with pytest.raises(RuntimeError, match="z order"):
        split_by_mesh([(xyz[::-1].copy(), argb)], 4, 8)
