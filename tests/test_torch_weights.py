"""Input-area weights: `input_area_weights=True` (K1's `ref_weights` variant
and the textured pass's) on the CPU against the JAX package run with
O2V_WEIGHT_MODE=input_area.

Tolerances (PARITY.md "Fidelity scope"): the voxel set exactly, MAX colors
byte for byte, BLEND colors within 1 LSB per channel; the pass's plain
version's weights equal a float32 numpy area in the JAX kernel's order bit
for bit.  The JAX reference ran op by op (`jax.disable_jit()`);
tests/fixtures/jax_weights.npz holds its outputs
(scripts/jax_test_references.py).
"""

import numpy as np
import pytest
import torch

from jax_reference import reference, voxel_dict
import obj2voxel_tpu_torch as pt
from obj2voxel_tpu_torch import constants as C
from obj2voxel_tpu_torch.ops.pass_fused import fused_pass, fused_pass_ref

torch.set_num_threads(1)

TILE = 1 << 14
BOUNDS = (np.zeros(3, np.float32), np.ones(3, np.float32))


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


def _soup_arrays(n, seed):
    """n colored triangles up to ~3 voxels wide at r = 32."""
    rng = np.random.default_rng(seed)
    centers = rng.random((n, 1, 3), dtype=np.float32)
    return ((centers + rng.uniform(-0.05, 0.05, (n, 3, 3))).astype(np.float32),
            np.zeros((n, 3, 2), np.float32), np.full(n, C.TRI_UNTEXTURED, np.int32),
            rng.random((n, 3), dtype=np.float32), np.full(n, -1, np.int32))


def weights_case(case):
    """(arrays, textures, options) of each case; the bounds are `BOUNDS`."""
    if case == "textured":
        from test_torch_textures import _random_textured

        return (*_random_textured(40, 16, 1.4, seed=3),
                dict(resolution=16, pair_tile=TILE))
    return (_soup_arrays(200, seed=8), None,
            dict(resolution=32, pair_tile=TILE, strategy=int(case.split("_")[1])))


WEIGHTS_CASES = [f"untextured_{s}" for s in (C.MAX_STRATEGY, C.BLEND_STRATEGY)] + [
    "textured"]


def _both(case):
    """(port, reference, port without input-area weights) voxel dicts; the
    reference is the JAX package's under O2V_WEIGHT_MODE=input_area."""
    from test_torch_textures import _pool, texture_arrays

    arrays, textures, kw = weights_case(case)

    def pool(cls):
        return _pool(cls, textures) if textures else None

    kw = dict(kw, bounds=BOUNDS)
    port = _voxels(pt.voxelize_soup(pt.TriangleSoup(*arrays), pool(pt.TexturePool),
                                    device="cpu", input_area_weights=True, **kw))
    plain = _voxels(pt.voxelize_soup(pt.TriangleSoup(*arrays), pool(pt.TexturePool),
                                     device="cpu", **kw))
    del kw["bounds"]
    ref = voxel_dict(reference("weights", case, *arrays,
                               *(texture_arrays(textures) if textures else []),
                               *BOUNDS, weight_mode="input_area", **kw))
    return port, ref, plain


@pytest.mark.parametrize("strategy", [C.MAX_STRATEGY, C.BLEND_STRATEGY],
                         ids=["max", "blend"])
def test_untextured_soup_matches_jax(strategy):
    port, ref, plain = _both(f"untextured_{strategy}")
    assert set(port) == set(ref) == set(plain)
    assert _max_lsb(port, ref) <= (1 if strategy == C.BLEND_STRATEGY else 0)
    assert len(port) > 500
    # the weights changed colors where triangles share voxels
    assert sum(port[k] != plain[k] for k in port) > 10


def test_textured_soup_matches_jax():
    port, ref, plain = _both("textured")
    assert port == ref
    assert set(port) == set(plain) and port != plain


def test_environment_default_is_read_per_call(monkeypatch):
    arrays = _soup_arrays(60, seed=9)
    kw = dict(resolution=16, pair_tile=TILE, strategy=C.BLEND_STRATEGY,
              bounds=BOUNDS, device="cpu")
    on = _voxels(pt.voxelize_soup(pt.TriangleSoup(*arrays), input_area_weights=True, **kw))
    off = _voxels(pt.voxelize_soup(pt.TriangleSoup(*arrays), **kw))
    assert on != off
    monkeypatch.setenv("O2V_WEIGHT_MODE", "input_area")
    assert _voxels(pt.voxelize_soup(pt.TriangleSoup(*arrays), **kw)) == on
    assert _voxels(pt.voxelize_soup(pt.TriangleSoup(*arrays),
                                    input_area_weights=False, **kw)) == off


def _np_area(t):
    """0.5 * |e1 x e2| in float32, in obj2voxel_tpu/ops/pass_fused.py's
    order, rounding every operation."""
    t = t.astype(np.float32)
    e1 = [t[:, 3 + a] - t[:, a] for a in range(3)]
    e2 = [t[:, 6 + a] - t[:, a] for a in range(3)]
    cx = e1[1] * e2[2] - e1[2] * e2[1]
    cy = e1[2] * e2[0] - e1[0] * e2[2]
    cz = e1[0] * e2[1] - e1[1] * e2[0]
    sq = cx * cx + cy * cy + cz * cz
    return np.float32(0.5) * np.sqrt(sq.astype(np.float64)).astype(np.float32)


def test_fused_pass_ref_weights_on_split_triangles():
    # three slanted triangles, each clipped into many voxel pieces
    rng = np.random.default_rng(10)
    table = np.zeros((3, 24), np.float32)
    table[:, 0:9] = rng.uniform(1.1, 6.9, (3, 9))
    table[:, 17:20] = rng.random((3, 3))
    t = torch.from_numpy(table)
    kw = dict(expand=512, budget=512, wide_local=False)
    want = _np_area(table)
    for row in range(3):
        args = (t, row, 1, 0, 0, 8, 8)
        plain = fused_pass(*args, **kw)
        area = fused_pass(*args, ref_weights=True, **kw)
        n = int(plain[5])
        assert n > 10
        # the same live pairs; each weighs its triangle's whole area, and the
        # color channels follow the weight
        assert torch.equal(area[0], plain[0]) and torch.equal(area[5], plain[5])
        np.testing.assert_array_equal(area[1][:n].numpy(), np.full(n, want[row]))
        for j in range(3):
            np.testing.assert_array_equal(area[2 + j][:n].numpy(),
                                          np.full(n, want[row] * table[row, 17 + j]))
        assert (plain[1][:n].numpy() < want[row]).all()
        assert torch.equal(fused_pass_ref(*args, ref_weights=True, **kw)[1], area[1])
