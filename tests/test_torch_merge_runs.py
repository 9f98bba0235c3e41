"""K6 and the merge-runs route: obj2voxel_tpu_torch.ops.merge_pallas and
`voxelize_soup(merge_runs=True)` on the CPU against the JAX package.

Tolerances: the merge is a permutation, so keys and channels are equal bit
for bit to the JAX kernel (interpret mode), to the JAX stable-sort oracle
and to `torch.sort(stable=True)`; through the engine the voxel set and the
bytes equal the JAX package's and the port's default route (the cube is
materialless, so MAX and BLEND bytes are all white).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obj2voxel_tpu import engine as jeng
from obj2voxel_tpu.ops import merge_pallas as jmerge
import obj2voxel_tpu_torch as pt
from obj2voxel_tpu_torch import engine
from obj2voxel_tpu_torch.ops.merge_pallas import (
    MAX_RUNS, merge_runs, plan_runs,
)

torch.set_num_threads(1)

INV = (1 << 31) - 1


def _runs(rng, counts, key_hi=1 << 20):
    """Dense key-sorted runs of `counts` rows with random channels."""
    keys = np.concatenate([np.sort(rng.randint(0, key_hi, c)).astype(np.int32)
                           for c in counts] or [np.zeros(0, np.int32)])
    chans = [rng.rand(keys.size).astype(np.float32) for _ in range(4)]
    return keys, chans


def _port_merge(keys, chans, counts):
    offsets, _ = plan_runs(counts)
    k, ch = merge_runs(torch.from_numpy(keys),
                       tuple(torch.from_numpy(c) for c in chans), offsets)
    return k.numpy(), [c.numpy() for c in ch]


def _assert_stable_sort(keys, chans, got_k, got_ch):
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[order])
    for g, c in zip(got_ch, chans):
        np.testing.assert_array_equal(g, c[order])


def test_merge_matches_jax_kernel():
    """The port against merge_runs_pallas(interpret=True): S = 5 runs,
    n_block 1024; the JAX buffer pads each run to the block with INVALID
    rows, so its live rows are compared."""
    rng = np.random.RandomState(5)
    n_block = 1024
    counts = [int(rng.randint(1, 4 * n_block)) for _ in range(5)]
    keys, chans = _runs(rng, counts, key_hi=50)
    aligned, levels, spad = jmerge.plan_runs(counts, n_block)
    p = aligned[-1]
    pb = p + (n_block // 128 + jmerge._WIN_PAD) * 128
    jk = np.full(pb, INV, np.int32)
    jc = [np.zeros(pb, np.float32) for _ in range(4)]
    dense, _ = plan_runs(counts)
    for i, c in enumerate(counts):
        jk[aligned[i]:aligned[i] + c] = keys[dense[i]:dense[i + 1]]
        for a, b in zip(jc, chans):
            a[aligned[i]:aligned[i] + c] = b[dense[i]:dense[i + 1]]
    aoff = np.asarray(aligned + [p] * (spad + 1 - len(aligned)), np.int32)
    ok, oc = jmerge.merge_runs_pallas(
        jnp.asarray(jk), tuple(jnp.asarray(c) for c in jc), jnp.asarray(aoff),
        p=p, n_block=n_block, levels=levels, spad=spad, interpret=True)
    n = keys.size
    got_k, got_ch = _port_merge(keys, chans, counts)
    np.testing.assert_array_equal(got_k, np.asarray(ok)[:n])
    for g, c in zip(got_ch, oc):
        np.testing.assert_array_equal(g, np.asarray(c)[:n])


# the cases of tests/test_merge_pallas.py, without the TPU layout
CASES = {f"random_s{s}": (s, None) for s in (1, 2, 3, 5, 8)}
CASES["heavy_duplicates"] = (7, 5)
CASES["empty_and_tiny"] = (11, 1 << 20)


@pytest.mark.parametrize("name", list(CASES))
def test_merge_matches_jax_oracle(name):
    seed, key_hi = CASES[name]
    rng = np.random.RandomState(seed)
    if name == "empty_and_tiny":
        counts = [0, 3, 0, 2048, 1, 0, 700]
    elif name == "heavy_duplicates":
        counts = [int(rng.randint(1, 3 * 1024)) for _ in range(6)]
    else:
        counts = [int(rng.randint(0, 4 * 1024)) for _ in range(seed)]
    keys, chans = _runs(rng, counts, key_hi or 1 << 20)
    want_k, want_ch = jmerge.merge_runs_ref(keys, chans, keys.size)
    got_k, got_ch = _port_merge(keys, chans, counts)
    np.testing.assert_array_equal(got_k, want_k)
    for g, w in zip(got_ch, want_ch):
        np.testing.assert_array_equal(g, w)
    # the same order as torch.sort(stable=True), which the default merge runs
    sk, idx = torch.sort(torch.from_numpy(keys), stable=True)
    np.testing.assert_array_equal(got_k, sk.numpy())
    np.testing.assert_array_equal(got_ch[0], chans[0][idx.numpy()])


@pytest.mark.parametrize("s", [2, 3, 11, 32])
def test_merge_stable_on_duplicates_and_empty_runs(s):
    rng = np.random.RandomState(100 + s)
    counts = [int(c) for c in rng.randint(0, 300, s)]
    counts[s // 2] = 0
    keys, chans = _runs(rng, counts, key_hi=4)
    _assert_stable_sort(keys, chans, *_port_merge(keys, chans, counts))


def test_plan_runs_levels():
    for s in range(1, MAX_RUNS + 2):
        offsets, levels = plan_runs([3] * s)
        assert offsets == [3 * i for i in range(s + 1)]
        assert levels == int(np.ceil(np.log2(s)))
    with pytest.raises(ValueError):
        merge_runs(torch.zeros(MAX_RUNS + 1, dtype=torch.int32),
                   tuple(torch.zeros(MAX_RUNS + 1) for _ in range(4)),
                   list(range(MAX_RUNS + 2)))


@pytest.fixture
def run_log(monkeypatch):
    """The number of runs of every K6 merge the engine asks for."""
    log, inner = [], engine.merge_sorted_runs

    def logged(keys, chans, offsets):
        log.append(len(offsets) - 1)
        return inner(keys, chans, offsets)

    monkeypatch.setattr(engine, "merge_sorted_runs", logged)
    return log


def _voxels(gen):
    out = {}
    for xyz, argb in gen:
        for p, c in zip(xyz.tolist(), argb.tolist()):
            assert tuple(p) not in out, "duplicate voxel"
            out[tuple(p)] = c
    return out


@pytest.fixture(scope="module")
def cube_m():
    from conftest import UNIT_CUBE_QUADS, UNIT_CUBE_VERTICES, quads_to_tris

    return quads_to_tris(UNIT_CUBE_VERTICES, UNIT_CUBE_QUADS)


@pytest.fixture(scope="module")
def jax_cube(cube_m):
    """The JAX package's cube at r = 128, run op by op with its default
    merge, which tests/test_merge_pallas.py holds equal to its
    O2V_MERGE_RUNS=1 merge (that route, run op by op, took 82 s alone).  The
    cube is materialless: every voxel is white, so the pass budget (2^17
    here, the quicker reference) cannot change the output."""
    with jax.disable_jit():
        return _voxels(jeng.voxelize_soup(
            jeng.TriangleSoup.from_vertices(cube_m), resolution=128,
            pair_tile=1 << 17))


@pytest.mark.parametrize("strategy", [pt.MAX_STRATEGY, pt.BLEND_STRATEGY],
                         ids=["max", "blend"])
def test_engine_merge_runs_matches_jax_and_default(jax_cube, cube_m, run_log,
                                                   strategy):
    # tile 2^14: the cube's slabs hold several passes each
    soup = pt.TriangleSoup.from_vertices(cube_m)
    kw = dict(resolution=128, pair_tile=1 << 14, strategy=strategy, device="cpu")
    got = _voxels(pt.voxelize_soup(soup, merge_runs=True, **kw))
    assert run_log and all(2 <= s <= MAX_RUNS for s in run_log)
    assert got == jax_cube
    run_log.clear()
    assert _voxels(pt.voxelize_soup(soup, **kw)) == got
    assert not run_log  # off by default


def _flat_soup(n, r, seed):
    """n small colored triangles, each inside one voxel of the z = r/2
    layer of an r^3 grid: one k = 0 bucket in one two-voxel slab."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, r, (n, 2)) + 0.5
    verts = np.empty((n, 3, 3), np.float64)
    verts[:, :, :2] = cells[:, None, :] + rng.uniform(-0.35, 0.35, (n, 3, 2))
    verts[:, :, 2] = r / 2 + 0.5 + rng.uniform(-0.35, 0.35, (n, 3))
    unit = ((verts - 0.25) / (r - 0.5)).astype(np.float32)
    return pt.TriangleSoup(unit, np.zeros((n, 3, 2), np.float32),
                           np.full(n, 2, np.int32),
                           rng.random((n, 3), dtype=np.float32),
                           np.full(n, -1, np.int32))


@pytest.mark.parametrize("budget,runs_taken", [(1 << 8, True), (1 << 6, False)],
                         ids=["10_runs", "40_runs"])
def test_route_taken_for_2_to_32_runs(run_log, budget, runs_taken):
    # 2560 one-voxel triangles in one slab: 10 passes of 2^8 slots, or 40
    # of 2^6, more than K6 takes (those take the sort merge)
    soup = _flat_soup(2560, 16, seed=3)
    bounds = (np.zeros(3, np.float32), np.ones(3, np.float32))
    kw = dict(resolution=16, pair_tile=budget, max_pass_budget=budget,
              bounds=bounds, device="cpu", strategy=pt.MAX_STRATEGY)
    got = _voxels(pt.voxelize_soup(soup, merge_runs=True, **kw))
    assert run_log == ([2560 // budget] if runs_taken else [])
    assert _voxels(pt.voxelize_soup(soup, merge_runs=False, **kw)) == got
    assert len(got) > 200


def test_route_not_taken_under_supersampling(run_log, monkeypatch):
    monkeypatch.setenv("O2V_MERGE_RUNS", "1")
    soup = _flat_soup(2560, 16, seed=4)
    bounds = (np.zeros(3, np.float32), np.ones(3, np.float32))
    kw = dict(resolution=8, supersampling=2, pair_tile=1 << 8,
              max_pass_budget=1 << 8, bounds=bounds, device="cpu")
    got = _voxels(pt.voxelize_soup(soup, **kw))
    assert got and not run_log
    # the environment is read per call: on, the unsampled route takes K6
    _voxels(pt.voxelize_soup(soup, **{**kw, "resolution": 16, "supersampling": 1}))
    assert run_log == [10]
