"""The whole slice: obj2voxel_tpu_torch.voxelize_soup(device="cpu") against
obj2voxel_tpu.engine.voxelize_soup on the same inputs.

Parity contract (PARITY.md "Fidelity scope"): the voxel set must match
exactly, MAX colors byte for byte, BLEND colors within 1 LSB per channel;
the closed-form fixtures must give their exact counts.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import (
    THREE_PLANES_QUADS, THREE_PLANES_VERTICES, UNIT_CUBE_QUADS, UNIT_CUBE_VERTICES,
    expected_unit_cube_voxels, quads_to_tris,
)
from jax_reference import reference, voxel_dict
import obj2voxel_tpu_torch as pt
from obj2voxel_tpu_torch import constants as C

torch.set_num_threads(1)

#: pass-budget cap of the JAX references
TILE = 1 << 14


def _voxels(gen):
    out = {}
    for xyz, argb in gen:
        assert xyz.dtype == np.int32 and argb.dtype == np.uint32
        for p, c in zip(xyz.tolist(), argb.tolist()):
            assert tuple(p) not in out, "duplicate voxel"
            out[tuple(p)] = c
    return out


def _jax(case, *arrays, **kw):
    """The JAX package's `voxelize_soup` on these inputs, run op by op
    (jitted XLA CPU programs contract multiply-adds into FMAs, which the
    port does not), as tests/fixtures/jax_engine.npz holds it."""
    return voxel_dict(reference("engine", case, *arrays, **kw))


def _port(soup, **kw):
    if isinstance(soup, np.ndarray):
        soup = pt.TriangleSoup.from_vertices(soup)
    return _voxels(pt.voxelize_soup(soup, device="cpu", **kw))


def _max_lsb(a, b):
    keys = list(a)
    x = np.array([a[k] for k in keys], np.uint32).view(np.uint8).astype(np.int16)
    y = np.array([b[k] for k in keys], np.uint32).view(np.uint8).astype(np.int16)
    return int(np.abs(x - y).max()) if keys else 0


#: the random soups' bounds: the unit cube, so both packages share the
#: transform exactly
BOUNDS = (np.zeros(3, np.float32), np.ones(3, np.float32))


def _random_soup(cls, n=300, seed=0):
    """n random colored triangles a few voxels wide at r = 64."""
    rng = np.random.default_rng(seed)
    centers = rng.random((n, 1, 3), dtype=np.float32)
    return cls(
        verts=(centers + rng.uniform(-0.05, 0.05, (n, 3, 3))).astype(np.float32),
        uvs=np.zeros((n, 3, 2), np.float32),
        types=np.full(n, 2, np.int32),
        rgb=rng.random((n, 3), dtype=np.float32),
        tex=np.full(n, -1, np.int32),
    )


def soup_arrays(soup):
    """A soup's five arrays, in the constructor's order."""
    return soup.verts, soup.uvs, soup.types, soup.rgb, soup.tex


def shape_tris(shape):
    """The closed-form fixtures' triangles."""
    if shape == "cube":
        return quads_to_tris(UNIT_CUBE_VERTICES, UNIT_CUBE_QUADS)
    return quads_to_tris(THREE_PLANES_VERTICES, THREE_PLANES_QUADS)


@pytest.fixture(scope="module")
def cube_tris_m():
    return shape_tris("cube")


CLOSED_FORMS = [
    ("cube", 32, expected_unit_cube_voxels(32)),
    ("cube", 64, expected_unit_cube_voxels(64)),
    ("planes", 32, 3 * 32 * 32),
    # x lands exactly on 64.0 at r = 128: the boundary-aligned plane
    ("planes", 128, 3 * 128 * 128),
]


@pytest.mark.parametrize("shape,r,want", CLOSED_FORMS)
def test_closed_forms_match_jax(shape, r, want):
    tris = shape_tris(shape)
    got = _port(tris, resolution=r, pair_tile=TILE)
    ref = _jax(f"{shape}_{r}", tris, resolution=r, pair_tile=TILE)
    assert len(got) == len(ref) == want
    assert got == ref  # materialless: white, byte for byte


def _jax_random_soup(strategy):
    return _jax(f"random_{strategy}", *soup_arrays(_random_soup(pt.TriangleSoup)),
                *BOUNDS, resolution=64, pair_tile=TILE, strategy=strategy)


@pytest.mark.parametrize("strategy", [C.MAX_STRATEGY, C.BLEND_STRATEGY],
                         ids=["max", "blend"])
def test_random_soup_matches_jax(strategy):
    ref = _jax_random_soup(strategy)
    got = _port(_random_soup(pt.TriangleSoup), resolution=64, pair_tile=TILE,
                strategy=strategy, bounds=BOUNDS)
    assert set(got) == set(ref)
    assert len(got) > 1000
    assert _max_lsb(got, ref) <= (1 if strategy == C.BLEND_STRATEGY else 0)


@pytest.mark.parametrize("strategy", [C.MAX_STRATEGY, C.BLEND_STRATEGY],
                         ids=["max", "blend"])
def test_multislab_multipass_matches_jax(strategy):
    # tiny budgets: several slabs, several passes per slab; pass
    # partitioning must not change the output
    ref = _jax_random_soup(strategy)
    got = _port(_random_soup(pt.TriangleSoup), resolution=64,
                pair_tile=1 << 12, max_pass_budget=1 << 12, strategy=strategy,
                bounds=BOUNDS)
    assert set(got) == set(ref)
    assert _max_lsb(got, ref) <= (1 if strategy == C.BLEND_STRATEGY else 0)


def test_giant_triangles_match_closed_form(cube_tris_m):
    # at budget 2^12 the r = 128 faces exceed one pass: wide_local passes
    r = 128
    got = _port(cube_tris_m, resolution=r, pair_tile=1 << 12,
                max_pass_budget=1 << 12)
    assert len(got) == expected_unit_cube_voxels(r)
    assert set(got.values()) == {0xFFFFFFFF}


def test_plan_group_changes_no_voxel():
    soup = _random_soup(pt.TriangleSoup, n=120, seed=3)
    a = _port(soup, resolution=48, pair_tile=1 << 12, group=8)
    b = _port(soup, resolution=48, pair_tile=1 << 12, group=1)
    assert a == b


def test_empty_mesh_yields_nothing():
    assert list(pt.voxelize_soup(pt.TriangleSoup.empty(), resolution=8,
                                 device="cpu")) == []


def test_device_outputs_match_host_outputs():
    from obj2voxel_tpu_torch.engine import stream_slabs

    soup = _random_soup(pt.TriangleSoup, n=200, seed=4)
    verts = (soup.verts * np.float32(30.0) + np.float32(1.0)).astype(np.float32)
    table = pt.table_from_numpy(
        pt.build_tri_table(verts, soup.uvs, soup.types, soup.rgb, soup.tex,
                           n_pad=256),
        "cpu",
    )
    vmin = np.floor(verts.min(axis=1)).astype(np.int32)
    vmax = (np.floor(verts.max(axis=1)) + 1).astype(np.int32)
    kw = dict(aabb_host=(vmin, vmax), stride=32, z_extent=32, is_blend=True,
              pair_tile=1 << 12)
    host = _voxels(stream_slabs(table, **kw))
    dev = {}
    for xyz, argb, count in stream_slabs(table, device_outputs=True, **kw):
        assert isinstance(xyz, torch.Tensor) and xyz.shape[0] >= count
        assert argb.dtype == torch.uint32
        for p, c in zip(xyz[:count].tolist(), argb[:count].numpy().tolist()):
            dev[tuple(p)] = c
    assert len(host) > 500
    assert dev == host


def test_textured_pool_voxelizes(cube_tris_m):
    # a non-empty pool used to raise; now its triangles sample their texture
    pool = pt.TexturePool()
    pool.add(np.array([[0xFF102030, 0xFF405060]], np.uint32), C.UV_CLAMP)
    soup = pt.TriangleSoup.from_vertices(cube_tris_m)
    soup.types[:] = C.TRI_TEXTURED
    soup.tex[:] = 0
    soup.uvs[:] = [[0.1, 0.5], [0.2, 0.5], [0.3, 0.5]]
    got = _voxels(pt.voxelize_soup(soup, pool, resolution=8, device="cpu"))
    assert len(got) == expected_unit_cube_voxels(8)
    assert set(got.values()) == {0xFF102030}


def test_package_imports_no_jax():
    root = Path(__file__).resolve().parent.parent
    code = (
        "import sys; import obj2voxel_tpu_torch, obj2voxel_tpu_torch.engine; "
        "import obj2voxel_tpu_torch.api, obj2voxel_tpu_torch.cli; "
        "import obj2voxel_tpu_torch.ops.merge_pallas; "
        "import obj2voxel_tpu_torch.parallel.mesh, obj2voxel_tpu_torch.ops.morton; "
        "import obj2voxel_tpu_torch.capi; "
        "import obj2voxel_tpu_torch.bench, obj2voxel_tpu_torch.scale; "
        "from obj2voxel_tpu_torch import densify, voxelize_batch; "
        "from obj2voxel_tpu_torch.ops.clip_pallas import "
        "clip_triangles_to_voxels_pallas; "
        "from obj2voxel_tpu_torch.io import debug_stl, native, obj_loader, "
        "png_io, stl_loader, writers; "
        "from obj2voxel_tpu_torch.utils import meshes; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'obj2voxel_tpu' or m.startswith('obj2voxel_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
