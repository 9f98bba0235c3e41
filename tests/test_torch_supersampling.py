"""2x supersampling: obj2voxel_tpu_torch on the CPU against the JAX package.

Tolerances (PARITY.md "Fidelity scope"): the voxel set exactly, MAX colors
byte for byte, BLEND colors within 1 LSB per channel; `downscale_keys` and
the two-cell oracle exactly.  The JAX reference ran op by op
(`jax.disable_jit()`), every pass at 2^14 slots (one shape to compile);
tests/fixtures/jax_supersampling.npz holds its outputs
(scripts/jax_test_references.py), and `downscale_keys` runs live.

The tie rule (ROADMAP Queue 3): a supersampled MAX tie goes to the earlier
pass, then the earlier fine key, then the earlier slot, as the JAX package
gives on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import UNIT_CUBE_QUADS, UNIT_CUBE_VERTICES, quads_to_tris
from jax_reference import reference, voxel_dict
from obj2voxel_tpu.ops import combine as jcombine
import obj2voxel_tpu_torch as pt
from obj2voxel_tpu_torch import constants as C
from obj2voxel_tpu_torch import cli as pcli
from obj2voxel_tpu_torch.engine import _merge_keys
from obj2voxel_tpu_torch.ops.combine import (
    INVALID_KEY, downscale_keys, finalize_colors,
)

torch.set_num_threads(1)

TILE = 1 << 14
BOUNDS = (np.zeros(3, np.float32), np.ones(3, np.float32))
CUBE = quads_to_tris(UNIT_CUBE_VERTICES, UNIT_CUBE_QUADS)


def _voxels(gen):
    out = {}
    for xyz, argb in gen:
        for p, c in zip(xyz.tolist(), argb.tolist()):
            assert tuple(p) not in out, "duplicate voxel"
            out[tuple(p)] = c
    return out


def _max_lsb(a, b):
    keys = list(a)
    x = np.array([a[k] for k in keys], np.uint32).view(np.uint8).astype(np.int16)
    y = np.array([b[k] for k in keys], np.uint32).view(np.uint8).astype(np.int16)
    return int(np.abs(x - y).max()) if keys else 0


def _assert_parity(port, ref, strategy):
    assert set(port) == set(ref)
    assert _max_lsb(port, ref) <= (1 if strategy == C.BLEND_STRATEGY else 0)


def _jax(case, *arrays, **kw):
    """The JAX package's output on these inputs, as
    tests/fixtures/jax_supersampling.npz holds it."""
    return voxel_dict(reference("supersampling", case, *arrays, **kw))


def soup_arrays(soup):
    return soup.verts, soup.uvs, soup.types, soup.rgb, soup.tex


def _port(soup, pool=None, **kw):
    return _voxels(pt.voxelize_soup(soup, pool, device="cpu", **kw))


def test_downscale_keys_matches_jax():
    stride = 8
    keys = np.append(np.arange(stride ** 3, dtype=np.int32), INVALID_KEY)
    want = np.asarray(jcombine.downscale_keys(jnp.asarray(keys), stride))
    got = downscale_keys(torch.from_numpy(keys), stride).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[-1] == INVALID_KEY


@pytest.mark.parametrize("is_blend", [True, False], ids=["blend", "max"])
def test_two_cell_oracle(is_blend):
    """tests/test_supersampling.py's oracle through the port's merge: eight
    samples in one 2x2x2 cell, two in another; weights in eighths and colors
    in quarters, so every sum is exact."""
    stride = 4
    coords = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)]
                      + [[2, 0, 0], [3, 1, 1]], np.int64)
    keys = (coords[:, 0] + stride * coords[:, 1]
            + stride * stride * coords[:, 2]).astype(np.int32)
    w = np.array([1, 2, 3, 4, 5, 6, 7, 8, 2, 2], np.float32) / 8.0
    rgb = np.stack([np.linspace(0, 1, 10).round(2), np.full(10, 0.25),
                    np.full(10, 0.75)], axis=1).astype(np.float32)
    rgb = (rgb * 4).round() / 4.0
    vals = np.concatenate([w[:, None], w[:, None] * rgb], axis=1).astype(np.float32)

    dk = downscale_keys(torch.from_numpy(keys), stride)
    ok, och, oc = _merge_keys(dk, tuple(torch.from_numpy(vals[:, i].copy())
                                        for i in range(4)), is_blend)
    ov = torch.stack(och, dim=-1).numpy()
    assert int(oc) == 2 and ok[:2].tolist() == [0, 1]
    if is_blend:
        want_a, want_b = vals[:8].sum(axis=0), vals[8:].sum(axis=0)
    else:
        # cell A: the largest weight; cell B: a tie, the earlier fine key
        want_a, want_b = vals[7], vals[8]
    np.testing.assert_array_equal(ov[0], want_a)
    np.testing.assert_array_equal(ov[1], want_b)
    rgb_out = torch.stack(finalize_colors(tuple(torch.from_numpy(ov[:1, i].copy())
                                                for i in range(4))), -1).numpy()
    np.testing.assert_allclose(rgb_out[0], want_a[1:] / want_a[0], rtol=1e-6)


#: the cube case's options
CUBE_KW = dict(resolution=8, supersampling=2, pair_tile=TILE)


def test_cube_matches_jax_and_halving():
    ref = _jax("cube", CUBE, **CUBE_KW)
    soup = pt.TriangleSoup.from_vertices(CUBE)
    got = _port(soup, resolution=8, supersampling=2, pair_tile=TILE)
    assert got == ref
    # occupancy of (r = 8, supersampling 2) is the per-axis halving of r = 16
    fine = _port(soup, resolution=16, pair_tile=TILE)
    assert set(got) == {tuple(v // 2 for v in p) for p in fine}


def test_flat_color_cube_blends_to_its_color():
    soup = pt.TriangleSoup.from_vertices(CUBE)
    soup.types[:] = C.TRI_UNTEXTURED
    soup.rgb[:] = np.array([0.5, 0.25, 1.0], np.float32)
    got = _port(soup, resolution=8, supersampling=2, strategy=C.BLEND_STRATEGY,
                pair_tile=TILE)
    assert len(got) == 8 + 12 * 6 + 6 * 36
    assert set(got.values()) == {0xFF000000 | (0x80 << 16) | (0x40 << 8) | 0xFF}


def _one_voxel_soup(cls, n, r, seed):
    """n colored triangles, each inside one voxel of an r^3 sample grid
    (unit-cube bounds): one k = 0 bucket."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, r, (n, 3)) + 0.5
    verts = cells[:, None, :] + rng.uniform(-0.35, 0.35, (n, 3, 3))
    unit = ((verts - 0.25) / (r - 0.5)).astype(np.float32)
    return cls(unit, np.zeros((n, 3, 2), np.float32), np.full(n, C.TRI_UNTEXTURED, np.int32),
               rng.random((n, 3), dtype=np.float32), np.full(n, -1, np.int32))


#: the seeded soup's options: one slab of one pass at 2^14 slots
SEEDED_KW = dict(resolution=32, supersampling=2, pair_tile=TILE)


@pytest.fixture(scope="module")
def jax_seeded():
    """The JAX package's seeded soup at r = 32, supersampling 2."""
    arrays = soup_arrays(_one_voxel_soup(pt.TriangleSoup, 3000, 64, seed=1))
    return {s: _jax(f"seeded_{s}", *arrays, *BOUNDS, strategy=s, **SEEDED_KW)
            for s in (C.MAX_STRATEGY, C.BLEND_STRATEGY)}


@pytest.fixture
def merge_log(monkeypatch):
    """The pass count of every slab the port merges."""
    from obj2voxel_tpu_torch import engine

    log, inner = [], engine._merge_slab

    def logged(live, n_passes, *args, **kw):
        log.append(n_passes)
        return inner(live, n_passes, *args, **kw)

    monkeypatch.setattr(engine, "_merge_slab", logged)
    return log


@pytest.mark.parametrize("budget", [TILE, 1 << 8], ids=["one_pass", "multi_pass"])
@pytest.mark.parametrize("strategy", [C.MAX_STRATEGY, C.BLEND_STRATEGY],
                         ids=["max", "blend"])
def test_seeded_soup_matches_jax(jax_seeded, merge_log, strategy, budget):
    # 3000 random-area triangles leave no MAX tie, so every partition of
    # the passes gives the JAX package's single-pass output
    soup = _one_voxel_soup(pt.TriangleSoup, 3000, 64, seed=1)
    got = _port(soup, resolution=32, supersampling=2, pair_tile=budget,
                max_pass_budget=budget, strategy=strategy, bounds=BOUNDS)
    _assert_parity(got, jax_seeded[strategy], strategy)
    assert len(got) > 2000
    if budget == TILE:
        assert merge_log == [1]
    else:
        assert max(merge_log) > 1


def tie_grid_inputs(budget):
    """ROADMAP Queue 3's fixture in voxel space (stride 8, MAX): a blue
    triangle first in the stream and a red one shifted by -1 in x clip to
    equal areas in fine voxels x = 1 and x = 0 of coarse voxel (0, 0, 0).
    The five arrays and `voxelize_grid`'s options."""
    blue = np.array([[1.25, 0.25, 0.5], [1.75, 0.25, 0.5], [1.25, 0.75, 0.5]],
                    np.float32)
    arrays = (np.stack([blue, blue - np.float32([1, 0, 0])]),
              np.zeros((2, 3, 2), np.float32), np.full(2, C.TRI_UNTEXTURED, np.int32),
              np.array([[0, 0, 1], [1, 0, 0]], np.float32), np.full(2, -1, np.int32))
    kw = dict(stride=8, z_extent=8, is_blend=False, do_down=True,
              pair_tile=budget, max_pass_budget=budget)
    return arrays, kw


def _tie_grid(budget):
    arrays, kw = tie_grid_inputs(budget)
    return _voxels(pt.voxelize_grid(*arrays, device="cpu", **kw))


@pytest.mark.parametrize("budget,color", [(TILE, 0xFFFF0000), (1, 0xFF0000FF)],
                         ids=["one_pass_red", "pass_per_triangle_blue"])
def test_queue3_tie_follows_the_rule(budget, color):
    # one pass: the earlier fine key (x = 0, red); one pass per triangle:
    # the earlier pass (blue)
    got = _tie_grid(budget)
    assert got == {(0, 0, 0): color}
    arrays, kw = tie_grid_inputs(budget)
    assert got == _jax(f"tie_{budget}", *arrays, **kw)


#: the textured soup's options (and its unit-cube bounds)
TEXTURED_KW = dict(resolution=8, supersampling=2, pair_tile=TILE,
                   strategy=C.MAX_STRATEGY)


def textured_inputs():
    from test_torch_textures import _random_textured

    return _random_textured(40, 16, 1.4, seed=2)


def test_textured_soup_matches_jax():
    from test_torch_textures import _pool, _soup, texture_arrays

    arrays, textures = textured_inputs()
    got = _port(_soup(pt.TriangleSoup, arrays), _pool(pt.TexturePool, textures),
                bounds=BOUNDS, **TEXTURED_KW)
    ref = _jax("textured", *arrays, *BOUNDS, *texture_arrays(textures), **TEXTURED_KW)
    _assert_parity(got, ref, C.MAX_STRATEGY)
    assert len(got) > 50 and len(set(got.values())) > 10


def _vl32(data):
    q = np.frombuffer(data, ">u4").reshape(-1, 4)
    return {tuple(int(c) for c in row[:3]): int(row[3]) for row in q}


def test_instance_and_cli_match_voxelize_soup(tmp_path):
    rng = np.random.default_rng(6)
    tris = (rng.random((80, 1, 3)) + rng.uniform(-0.1, 0.1, (80, 3, 3))).round(6)
    obj = tmp_path / "m.obj"
    obj.write_text("\n".join([f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in tris.reshape(-1, 3)]
                             + [f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}" for i in range(80)])
                   + "\n")
    pt.set_log_level(C.LOG_LEVEL_SILENT)
    try:
        inst = pt.Instance("cpu")
        inst.set_input_file(str(obj))
        inst.set_output_memory("vl32")
        inst.set_resolution(12)
        inst.set_supersampling(2)
        assert inst.voxelize() == pt.ERR_OK
        out = tmp_path / "m.vl32"
        assert pcli.main([str(obj), str(out), "-r", "12", "-u", "--device", "cpu"]) == 0
    finally:
        pt.set_log_level(C.LOG_LEVEL_INFO)
    got = _vl32(inst.get_output_memory())
    soup = pt.TriangleSoup.from_vertices(tris.astype(np.float32))
    want = _port(soup, resolution=12, supersampling=2)
    assert got == want and len(got) > 100
    assert out.read_bytes() == inst.get_output_memory()
