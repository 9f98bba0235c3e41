"""Textured meshes: obj2voxel_tpu_torch.voxelize_soup(device="cpu") against
obj2voxel_tpu.engine.voxelize_soup on the same inputs.

Parity contract (PARITY.md "Fidelity scope"): the voxel set exactly, MAX
colors byte for byte, BLEND colors within 1 LSB per channel.  The JAX
reference ran op by op (`jax.disable_jit()`: jitted XLA CPU programs take
minutes to compile here and contract multiply-adds into FMAs, which the
port does not); tests/fixtures/jax_textures.npz holds its outputs
(scripts/jax_test_references.py).
"""

import numpy as np
import pytest
import torch

from jax_reference import reference, voxel_dict
import obj2voxel_tpu_torch as pt
from obj2voxel_tpu_torch import constants as C

torch.set_num_threads(1)

BOUNDS = (np.zeros(3, np.float32), np.ones(3, np.float32))


def _voxels(gen):
    out = {}
    for xyz, argb in gen:
        for p, c in zip(xyz.tolist(), argb.tolist()):
            assert tuple(p) not in out, "duplicate voxel"
            out[tuple(p)] = c
    return out


def _soup(cls, arrays):
    return cls(*(np.array(a) for a in arrays))


def _pool(cls, textures):
    pool = cls()
    for img, wrap in textures:
        pool.add(img, wrap)
    return pool


def texture_arrays(textures):
    """A texture list's images and its wrap modes, as arrays."""
    return [img for img, _ in textures] + [np.array([w for _, w in textures], np.int32)]


def _both(case):
    """(port, reference) voxel dicts of one case of `textures_case`, over
    the unit-cube bounds."""
    arrays, textures, kw = textures_case(case)
    port = _voxels(pt.voxelize_soup(
        _soup(pt.TriangleSoup, arrays), _pool(pt.TexturePool, textures),
        device="cpu", bounds=BOUNDS, **kw))
    ref = voxel_dict(reference("textures", case, *arrays, *texture_arrays(textures),
                               *BOUNDS, **kw))
    return port, ref


def _max_lsb(a, b):
    keys = list(a)
    x = np.array([a[k] for k in keys], np.uint32).view(np.uint8).astype(np.int16)
    y = np.array([b[k] for k in keys], np.uint32).view(np.uint8).astype(np.int16)
    return int(np.abs(x - y).max()) if keys else 0


def _assert_parity(port, ref, strategy):
    assert set(port) == set(ref)
    assert _max_lsb(port, ref) <= (1 if strategy == C.BLEND_STRATEGY else 0)


# --- the fixtures of tests/test_textures.py ---------------------------------

def _plane(tri_type, rgb=(1.0, 1.0, 1.0), tex=-1):
    """One unit quad at z = 0.5 with full UV coverage, as arrays."""
    verts = np.array([[[0, 0, 0.5], [1, 0, 0.5], [1, 1, 0.5]],
                      [[0, 0, 0.5], [1, 1, 0.5], [0, 1, 0.5]]], np.float32)
    uvs = np.array([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]], np.float32)
    return (verts, uvs, np.full(2, tri_type, np.int32),
            np.tile(np.asarray(rgb, np.float32), (2, 1)), np.full(2, tex, np.int32))


def _red_green():
    img = np.zeros((2, 1), np.uint32)
    img[0, 0] = 0xFFFF0000
    img[1, 0] = 0xFF00FF00
    return img


def _two_planes():
    red = _plane(C.TRI_UNTEXTURED, rgb=(1.0, 0.0, 0.0))
    blue = _plane(C.TRI_UNTEXTURED, rgb=(0.0, 0.0, 1.0))
    return tuple(np.concatenate([a, b]) for a, b in zip(red, blue))


FIXTURES = {
    "materialless": (_plane(C.TRI_MATERIALLESS), [], C.MAX_STRATEGY),
    "flat_color": (_plane(C.TRI_UNTEXTURED, rgb=(1.0, 0.0, 0.0)), [], C.MAX_STRATEGY),
    "v_flip": (_plane(C.TRI_TEXTURED, tex=0), [(_red_green(), C.UV_CLAMP)],
               C.MAX_STRATEGY),
    "blend": (_two_planes(), [], C.BLEND_STRATEGY),
    "max_ties": (_two_planes(), [], C.MAX_STRATEGY),
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_texture_fixtures_match_jax(name):
    strategy = FIXTURES[name][2]
    port, ref = _both(name)
    assert len(port) > 0
    _assert_parity(port, ref, strategy)
    if name == "v_flip":
        assert set(port.values()) == {0xFFFF0000, 0xFF00FF00}


# --- a seeded random textured soup --------------------------------------------

def _random_textured(n, r, spread, seed=0, fixed=False):
    """n triangles around voxel centers of an r^3 grid, their vertices up to
    `spread` voxels away (with `fixed`, one triangle whose AABB is exactly
    2 spread wide, its axes permuted and flipped at random): 60% textured
    (four textures of odd sizes, CLAMP and REPEAT, UVs in [-2, 3]), the rest
    flat-colored or materialless."""
    rng = np.random.default_rng(seed)
    centers = (np.floor(rng.random((n, 1, 3)) * r) + 0.5) / r
    offsets = rng.uniform(-spread, spread, (n, 3, 3))
    if fixed:
        template = np.array([[-1, -1, -1], [1, -1, 1], [-1, 1, 0.3]])
        perm = np.argsort(rng.random((n, 3)), axis=1)
        offsets = spread * template[:, perm].transpose(1, 0, 2)
        offsets *= rng.choice([-1.0, 1.0], size=(n, 1, 3))
    verts = (centers + offsets / r).astype(np.float32)
    uvs = rng.uniform(-2, 3, (n, 3, 2)).astype(np.float32)
    kind = rng.random(n)
    types = np.where(kind < 0.6, C.TRI_TEXTURED,
                     np.where(kind < 0.85, C.TRI_UNTEXTURED, C.TRI_MATERIALLESS))
    rgb = rng.random((n, 3), dtype=np.float32)
    rgb[types == C.TRI_MATERIALLESS] = 1.0
    tex = np.where(types == C.TRI_TEXTURED, rng.integers(0, 4, n), -1)
    textures = []
    for i, (h, w) in enumerate([(3, 5), (7, 2), (1, 9), (13, 11)]):
        img = (0xFF000000 | rng.integers(0, 1 << 24, (h, w))).astype(np.uint32)
        textures.append((img, C.UV_CLAMP if i % 2 else C.UV_WRAP))
    arrays = (verts, uvs, types.astype(np.int32), rgb, tex.astype(np.int32))
    return arrays, textures


@pytest.fixture
def pass_log(monkeypatch):
    """The (z_lo, expand, wide_local) of every textured pass the port
    runs."""
    from obj2voxel_tpu_torch import engine

    log, inner = [], engine._textured_pass

    def logged(table, pool, r0, n_rows, local_base, z_lo, *args, **kw):
        log.append((z_lo, kw["expand"], kw["wide_local"]))
        return inner(table, pool, r0, n_rows, local_base, z_lo, *args, **kw)

    monkeypatch.setattr(engine, "_textured_pass", logged)
    return log


#: the seeded soups of `check_random_soup`: name -> `_random_textured`'s
#: arguments
RANDOM_SOUPS = {
    # triangles inside one voxel each share one bucket: one slab, one pass
    "one_pass": dict(n=200, r=16, spread=0.2),
    # triangles of one AABB size, 7 voxels a side: one bucket, so few
    # distinct pass shapes for the op-by-op reference to compile, and few
    # live pairs per slab, so every slab's merge has the same padded size
    "multi_pass": dict(n=60, r=32, spread=3.0, fixed=True),
}


def _giant_inputs():
    """An axis-aligned textured triangle, not subdivided: at r = 66 its AABB
    holds 66 x 66 slots, over the 2^12-slot pass budget."""
    img = (0xFF000000 | np.arange(35, dtype=np.uint32) * 0x050301).reshape(5, 7)
    arrays = tuple(a[:1] for a in _plane(C.TRI_TEXTURED, tex=0))
    arrays = (arrays[0] * np.float32([1, 1, 0.6]),
              arrays[1] * np.float32(2.5) - np.float32(0.7), *arrays[2:])
    return arrays, [(img, C.UV_WRAP)]


def textures_case(case):
    """(arrays, textures, options) of each case compared with the JAX
    package; every pass takes 2^12 slots (the op-by-op reference compiled
    each op once per shape)."""
    small = dict(pair_tile=1 << 12, max_pass_budget=1 << 12)
    if case in FIXTURES:
        arrays, textures, strategy = FIXTURES[case]
        return arrays, textures, dict(resolution=8, pair_tile=1 << 12, strategy=strategy)
    if case == "giant":
        return (*_giant_inputs(), dict(resolution=66, **small))
    if case == "one_texel":
        img = np.full((1, 1), 0xFFFF0000, np.uint32)
        return (_plane(C.TRI_TEXTURED, tex=0), [(img, C.UV_CLAMP)],
                dict(resolution=8, pair_tile=1 << 12))
    soup, strategy = case.rsplit("_", 1)
    kw = RANDOM_SOUPS[soup]
    return (*_random_textured(**kw), dict(resolution=kw["r"], strategy=int(strategy),
                                          **small))


TEXTURES_CASES = ([*FIXTURES, "giant", "one_texel"]
                  + [f"{soup}_{s}" for soup in RANDOM_SOUPS
                     for s in (C.MAX_STRATEGY, C.BLEND_STRATEGY)])


def check_random_soup(pass_log, strategy, soup):
    """Port against reference on the seeded soup `RANDOM_SOUPS[soup]`;
    returns the port's output."""
    case = f"{soup}_{strategy}"
    _, textures, _ = textures_case(case)
    port, ref = _both(case)
    _assert_parity(port, ref, strategy)
    # texels of every texture, under both wrap modes, reached the output
    if strategy == C.MAX_STRATEGY:
        for img, _ in textures:
            assert set(port.values()) & {int(c) for c in img.ravel()}
    return port


@pytest.mark.parametrize("strategy", [C.MAX_STRATEGY, C.BLEND_STRATEGY],
                         ids=["max", "blend"])
def test_random_textured_soup_one_pass_matches_jax(pass_log, strategy):
    port = check_random_soup(pass_log, strategy, "one_pass")
    assert len(pass_log) == 1
    assert len(port) > 100


def test_giant_textured_triangle_on_wide_passes(pass_log):
    # an axis-aligned triangle is not subdivided: at r = 66 its AABB holds
    # 66 x 66 slots, over the 2^12-slot pass budget, so all of its passes
    # are wide_local ones walking the slot domain
    port, ref = _both("giant")
    assert len(port) > 66 * 66 // 2
    _assert_parity(port, ref, C.MAX_STRATEGY)
    assert len(set(port.values())) == 35
    assert len(pass_log) >= 2 and all(wide for _, _, wide in pass_log)


def test_one_texel_pool_takes_the_untextured_path():
    # a pool of one 1x1 texture packs one pixel, which the JAX package takes
    # for "no textures" (engine.py:503): textured triangles get their flat
    # color, here white, instead of the texel
    port, ref = _both("one_texel")
    assert port == ref
    assert set(port.values()) == {0xFFFFFFFF}


def test_textured_pass_launch_path_on_cpu():
    # the textured pass hands K4 its whole budget and K3 the pass outputs;
    # on CPU tensors both take their plain versions and count no launch
    pt.reset_launches()
    arrays, textures = _random_textured(40, 16, 1.4, seed=1)
    out = _voxels(pt.voxelize_soup(
        _soup(pt.TriangleSoup, arrays), _pool(pt.TexturePool, textures),
        resolution=16, bounds=BOUNDS, pair_tile=1 << 12, device="cpu"))
    assert out
    assert all(n == 0 for n in pt.LAUNCHES.values())
