"""K6 and the merge-runs route: obj2voxel_tpu_torch.ops.merge_pallas and
`voxelize_soup(merge_runs=True)` on the CPU against the JAX package.

Tolerances: the merge is a permutation, so keys and channels are equal bit
for bit to the JAX kernel (interpret mode), to the JAX stable-sort oracle
and to `torch.sort(stable=True)`; through the engine the voxel set and the
bytes equal the JAX package's and the port's default route (the cube is
materialless, so MAX and BLEND bytes are all white).  The JAX kernel's and
the JAX package's cube outputs are those of tests/fixtures/jax_merge_runs.npz
(scripts/jax_test_references.py); the stable-sort oracle runs live.
"""

import ctypes

import numpy as np
import pytest
import torch

from jax_reference import reference, voxel_dict
from obj2voxel_tpu.ops import merge_pallas as jmerge
import obj2voxel_tpu_torch as pt
from obj2voxel_tpu_torch import engine
from obj2voxel_tpu_torch.ops import _cuda
from obj2voxel_tpu_torch.ops.merge_pallas import (
    MAX_RUNS, MERGE_TILE, merge_runs, plan_levels, plan_runs,
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


def kernel_case():
    """(keys, chans, counts, n_block) of the JAX kernel comparison: S = 5
    runs, n_block 1024."""
    rng = np.random.RandomState(5)
    n_block = 1024
    counts = [int(rng.randint(1, 4 * n_block)) for _ in range(5)]
    keys, chans = _runs(rng, counts, key_hi=50)
    return keys, chans, counts, n_block


def test_merge_matches_jax_kernel():
    """The port against merge_runs_pallas(interpret=True); the JAX buffer
    pads each run to the block with INVALID rows, so its live rows are
    compared."""
    keys, chans, counts, n_block = kernel_case()
    ref = reference("merge_runs", "kernel", keys, *chans, counts=counts,
                    n_block=n_block)
    ok, oc = ref["keys"], [ref[f"chan{j}"] for j in range(4)]
    n = keys.size
    got_k, got_ch = _port_merge(keys, chans, counts)
    np.testing.assert_array_equal(got_k, ok[:n])
    for g, c in zip(got_ch, oc):
        np.testing.assert_array_equal(g, c[:n])


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


# the K6 wrapper's host side, pure torch: level plan, launches, scratch

@pytest.mark.parametrize("counts", [
    [5, 0, 7], [MERGE_TILE] * 2, [MERGE_TILE + 1, 1, 0, 0, 3 * MERGE_TILE - 1],
    [0] * 31 + [10], list(range(32)), [1] * 17,
], ids=["s3", "whole_tiles", "off_tiles", "only_last", "s32", "s17"])
def test_plan_levels(counts):
    offsets, levels = plan_runs(counts)
    plans = plan_levels(offsets)
    assert MERGE_TILE == 128 * 15 and len(plans) == levels
    for level, plan in enumerate(plans):
        pairs = [plan[i:i + 4] for i in range(0, len(plan) - 1, 4)]
        assert len(plan) % 4 == 1 and 1 <= len(pairs) <= MAX_RUNS // 2
        # the pairs are the plain version's groups, end to end over the rows
        span = 2 << level
        assert len(pairs) == -(-len(counts) // span)
        assert pairs[0][0] == 0 and pairs[-1][2] == offsets[-1]
        tiles = 0
        for j, (a, m, e, first) in enumerate(pairs):
            assert a == offsets[j * span]
            assert m == offsets[min(j * span + span // 2, len(counts))]
            assert e == offsets[min((j + 1) * span, len(counts))]
            assert j == 0 or a == pairs[j - 1][2]
            # a pair without rows gets no tile
            assert first == tiles
            tiles += -(-(e - a) // MERGE_TILE)
        assert plan[-1] == tiles == sum(
            -(-(e - a) // MERGE_TILE) for a, _, e, _ in pairs)


@pytest.fixture
def fake_kernels(monkeypatch):
    """The K6 wrapper's call on meta tensors: the library records it instead
    of launching."""
    calls = []

    class Lib:
        def o2v_merge_runs(self, *args):
            plan = ctypes.cast(args[11], ctypes.POINTER(ctypes.c_int))
            flat, level = [], 0
            while level < args[12]:
                size = 2 + 4 * plan[len(flat)]
                flat += plan[len(flat):len(flat) + size]
                level += 1
            calls.append((flat, args[12], args[13], args[5:10]))
            return 0

    scratch = []
    empty = torch.empty

    def tracked_empty(*size, **kw):
        scratch.append(empty(*size, **kw))
        return scratch[-1]

    monkeypatch.setattr(_cuda, "lib", Lib)
    monkeypatch.setattr(_cuda, "require_cuda", lambda name, *t: t[0].device)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(torch, "empty", tracked_empty)
    _cuda.reset_launches()
    yield calls, scratch


@pytest.mark.parametrize("s", [1, 2, 3, 5, 12, 32])
def test_merge_wrapper_levels_and_scratch(fake_kernels, s):
    # one call launches one kernel a level; each level's plan is preceded by
    # its number of group pairs; the levels before the last pass composites
    # through at most two int64 buffers of one row each
    calls, made = fake_kernels
    counts = [1000 + 37 * i for i in range(s)]
    offsets, levels = plan_runs(counts)
    n = offsets[-1]
    keys = torch.zeros(n, dtype=torch.int32, device="meta")
    chans = tuple(torch.zeros(n, device="meta") for _ in range(4))
    del made[:]
    got_k, got_c = merge_runs(keys, chans, offsets)
    assert _cuda.LAUNCHES["merge_runs"] == levels
    if levels == 0:
        assert got_k is keys and got_c == chans and not calls
        return
    ((flat, n_levels, rows, outs),) = calls
    assert (n_levels, rows) == (levels, n)
    assert flat == [x for plan in plan_levels(offsets) for x in (len(plan) // 4, *plan)]
    out, scratch = made
    assert out.shape == (5, n) and out.dtype == torch.int32
    assert scratch.dtype == torch.int64
    assert scratch.numel() == min(levels - 1, 2) * n
    # the outputs are the rows of one buffer, at the pointers passed (a meta
    # tensor's pointer is 0, so they are byte offsets)
    assert list(outs) == [4 * n * i for i in range(5)]
    assert got_k.dtype == torch.int32 and got_k.shape == (n,)
    assert got_k.storage_offset() == 0
    for i, c in enumerate(got_c, 1):
        assert c.dtype == torch.float32 and c.shape == (n,)
        assert 4 * c.storage_offset() == outs[i]


@pytest.mark.parametrize("bad", ["dtype", "channels", "chan_dtype", "chan_shape",
                                 "start", "end", "falling", "too_many"])
def test_merge_runs_rejects_bad_inputs(bad):
    keys = torch.zeros(6, dtype=torch.int32)
    chans = [torch.zeros(6) for _ in range(4)]
    offsets = [0, 2, 6]
    if bad == "dtype":
        keys = keys.to(torch.int64)
    elif bad == "channels":
        chans = chans[:3]
    elif bad == "chan_dtype":
        chans[1] = chans[1].to(torch.float64)
    elif bad == "chan_shape":
        chans[2] = torch.zeros(7)
    elif bad == "start":
        offsets = [1, 2, 6]
    elif bad == "end":
        offsets = [0, 2, 5]
    elif bad == "falling":
        offsets = [0, 4, 2, 6]
    else:
        offsets = [0] * (MAX_RUNS + 1) + [6]
    with pytest.raises(ValueError, match="merge_runs"):
        merge_runs(keys, chans, offsets)


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


#: the JAX cube's options
JAX_CUBE = dict(resolution=128, pair_tile=1 << 17)


@pytest.fixture(scope="module")
def jax_cube(cube_m):
    """The JAX package's cube at r = 128, run op by op with its default
    merge, which tests/test_merge_pallas.py holds equal to its
    O2V_MERGE_RUNS=1 merge (that route, run op by op, took 82 s alone).  The
    cube is materialless: every voxel is white, so the pass budget (2^17
    here, the quicker reference) cannot change the output."""
    return voxel_dict(reference("merge_runs", "cube", cube_m, **JAX_CUBE))


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
