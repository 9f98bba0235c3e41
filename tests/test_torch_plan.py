"""The port's device planner against the JAX package's host planner.

At group = 1 the order and segments must be bit-identical to
obj2voxel_tpu.ops.plan.plan_mesh, as test_plan_device.py requires of the
JAX device planner.  Stage 1's wrapper `plan_hist` is checked here too:
its CUDA branch against a stand-in kernel library, and (marked `card`) its
kernel against the plain `_stage1` on a card.  The JAX package is imported
only where a test compares with it, so the `card` tests also run where JAX
is not installed:

    python -m pytest tests/test_torch_plan.py -m card --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from obj2voxel_tpu_torch import engine
from obj2voxel_tpu_torch.ops import _cuda
from obj2voxel_tpu_torch.ops import plan_device as tplan
from obj2voxel_tpu_torch.soup import TriangleSoup, build_tri_table

torch.set_num_threads(1)


def _random_mesh(n, res, seed):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(0, res, size=(n, 3, 3)).astype(np.float32)
    small = rng.random(n) < 0.7
    verts[small, 1:, :] = verts[small, :1, :] + rng.uniform(
        -2, 2, size=(int(small.sum()), 2, 3)
    ).astype(np.float32)
    return verts


def _table(verts, n_pad):
    n = verts.shape[0]
    return build_tri_table(
        verts, np.zeros((n, 3, 2), np.float32), np.ones(n, np.int32),
        np.ones((n, 3), np.float32), np.full(n, -1, np.int32), n_pad=n_pad,
    )


def _plans(n, res, slot_budget, seed, n_pad=None):
    from obj2voxel_tpu.ops.plan import plan_mesh

    verts = _random_mesh(n, res, seed)
    clamp_hi = np.array([res, res, res], np.float32)
    vmin = np.clip(np.floor(verts.min(axis=1)), 0, clamp_hi).astype(np.int64)
    vmax = np.clip(np.floor(verts.max(axis=1)) + 1, 0, clamp_hi).astype(np.int64)
    n_pad = n_pad or 1 << max(8, (n - 1).bit_length())
    table = _table(verts, n_pad)
    host = plan_mesh(vmin, vmax, res, res, slot_budget)
    dev = tplan.plan_mesh_device(torch.from_numpy(table), n, res, res, slot_budget)
    return table, host, dev


def _astuples(segs):
    return [dataclasses.astuple(s) for s in segs]


@pytest.mark.parametrize(
    "n,res,slot_budget,seed",
    [(500, 64, 1 << 12, 1), (500, 64, 1 << 16, 1), (2000, 128, 1 << 24, 2)],
    ids=["budget-2^12", "budget-2^16", "multislab"],
)
def test_plan_matches_host_planner(n, res, slot_budget, seed):
    _, (h_order, h_segs), (d_order, d_segs) = _plans(n, res, slot_budget, seed)
    assert d_order is not None
    assert _astuples(d_segs) == _astuples(h_segs)
    m = h_order.size
    np.testing.assert_array_equal(d_order[:m].numpy(), h_order)
    if seed == 2:
        assert len({(s.z_lo, s.z_hi) for s in h_segs}) > 1


def test_gather_ordered_matches_manual_gather():
    table, (h_order, h_segs), (d_order, _) = _plans(500, 64, 1 << 14, 4)
    m = h_segs[-1].r1
    got = tplan.gather_ordered(torch.from_numpy(table), d_order, m)
    np.testing.assert_array_equal(got.numpy(), table[h_order])


@pytest.mark.parametrize("group", [2, 8])
def test_group_plan_covers_host_plan(group):
    """Every host-plan incidence appears in the group plan, in a bucket at
    least as wide, with the group's rows gathered consecutively."""
    table, (h_order, h_segs), _ = _plans(700, 128, 1 << 23, 5)
    n_sub = 700
    order, segs = tplan.plan_mesh_device(torch.from_numpy(table), n_sub, 128,
                                         128, 1 << 23, group=group)
    gathered = tplan.gather_ordered(torch.from_numpy(table), order,
                                    segs[-1].r1, group).numpy()
    host_k = {}
    for s in h_segs:
        for r in range(s.r0, s.r1):
            host_k[(s.z_lo, s.z_hi, int(h_order[r]))] = s.k
    seen = set()
    for s in segs:
        assert s.r0 % group == 0 and s.r1 % group == 0
        for gr in range(s.r0 // group, s.r1 // group):
            gid = int(order[gr])
            np.testing.assert_array_equal(
                gathered[gr * group:(gr + 1) * group],
                table[gid * group:(gid + 1) * group],
            )
            for j in range(group):
                key = (s.z_lo, s.z_hi, gid * group + j)
                if key in host_k:
                    assert host_k[key] <= s.k
                    seen.add(key)
    assert seen == set(host_k)


def test_plan_histogram_is_int64_and_exact():
    table, _, _ = _plans(300, 64, 1 << 12, 6)
    per_row, vmin, vmax = tplan._stage1(torch.from_numpy(table), 300, 64, 64)
    assert per_row.dtype == torch.int64
    v = table[:300, :9].reshape(-1, 3, 3)
    lo = np.clip(np.floor(v.min(axis=1)), 0, 64).astype(np.int64)
    hi = np.clip(np.floor(v.max(axis=1)) + 1, 0, 64).astype(np.int64)
    want = np.zeros(64, np.int64)
    for a, b in zip(lo, hi):
        want[a[2]:b[2]] += (b[0] - a[0]) * (b[1] - a[1])
    np.testing.assert_array_equal(per_row.numpy(), want)


@pytest.mark.parametrize("c", [0, 1, 2, 3, 4, 5, 1023, 1024, 1025, (1 << 31) - 1])
def test_ceil_log2_exact(c):
    k = int(tplan._ceil_log2(torch.tensor([c], dtype=torch.int64))[0])
    want = 0 if c <= 1 else (c - 1).bit_length()
    assert k == want


def test_plan_falls_back_on_many_slabs():
    rng = np.random.default_rng(3)
    n, z_extent = 4000, 4096
    verts = _random_mesh(n, 64, 3)
    verts[:, :, 2] = np.float32(z_extent) * rng.random((n, 1), dtype=np.float32)
    table = _table(verts, 4096)
    got = tplan.plan_mesh_device(torch.from_numpy(table), n, 64, z_extent, 1 << 8)
    assert got == (None, None)


def test_plan_empty_mesh():
    table = np.zeros((256, 24), np.float32)
    assert tplan.plan_mesh_device(torch.from_numpy(table), 0, 16, 16, 1 << 12) == (None, [])


# --- stage 1's wrapper: plan_hist ---------------------------------------------


def _clamped_table(n, n_pad, stride, z_extent, seed):
    """A table whose AABBs reach past the grid on every side (the clamps),
    with n live rows of n_pad."""
    rng = np.random.default_rng(seed)
    hi = np.array([stride, stride, z_extent], np.float32)
    verts = (rng.uniform(-0.02, 1.02, (n, 1, 3)) * hi).astype(np.float32)
    verts = verts + rng.uniform(-3, 3, (n, 3, 3)).astype(np.float32)
    return torch.from_numpy(_table(verts, n_pad))


class _Lib:
    """A stand-in kernel library that records its calls."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def o2v_plan_hist(self, *args):
        self.calls.append(args)
        return self.err

    def o2v_error_string(self, err):
        return b"stand-in error"


def _cuda_branch(monkeypatch, lib, n_pad):
    """The CUDA branch on meta tensors (every pointer 0), `lib` in place of
    the kernel library."""
    monkeypatch.setattr(_cuda, "lib", lambda: lib)
    monkeypatch.setattr(_cuda, "require_cuda", lambda name, *t: t[0].device)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda dev: 0)
    return torch.zeros((n_pad, 24), device="meta")


@pytest.mark.parametrize("n_pad,n_sub,stride,z_extent", [
    (256, 0, 16, 16), (4096, 3001, 1024, 1024), (1 << 16, 40000, 64, 64000),
], ids=["empty", "mesh", "batch-stack"])
def test_plan_hist_wrapper_layout(monkeypatch, n_pad, n_sub, stride, z_extent):
    lib = _Lib()
    table = _cuda_branch(monkeypatch, lib, n_pad)
    _cuda.reset_launches()
    per_row, vmin, vmax = tplan.plan_hist(table, n_sub, stride, z_extent)
    assert _cuda.LAUNCHES["plan_hist"] == len(lib.calls) == 1
    assert sum(_cuda.LAUNCHES.values()) == 1
    args = lib.calls[0]
    assert len(args) == 10
    assert args[4:9] == (n_pad, n_sub, stride, z_extent,
                         int(tplan.hist_in_smem(z_extent)))
    assert per_row.dtype == torch.int64 and per_row.shape == (z_extent,)
    for v in (vmin, vmax):
        assert v.dtype == torch.int32 and v.shape == (n_pad, 3)
        assert v.is_contiguous()


@pytest.mark.parametrize("z_extent,shared", [
    (1024, True), (2048, True), (8192, True), (64000, False),
    (tplan.HIST_SMEM_BYTES // 8 - 1, True), (tplan.HIST_SMEM_BYTES // 8, False),
], ids=["1024", "2048", "8192", "64000", "at-limit", "past-limit"])
def test_plan_hist_route(monkeypatch, z_extent, shared):
    # the route is the bins' bytes against the limit, passed to the launch
    assert tplan.hist_in_smem(z_extent) is shared
    assert ((z_extent + 1) * 8 <= tplan.HIST_SMEM_BYTES) is shared
    lib = _Lib()
    table = _cuda_branch(monkeypatch, lib, 256)
    tplan.plan_hist(table, 200, 64, z_extent)
    assert lib.calls[0][8] == int(shared)


def test_plan_hist_raises_on_a_failed_launch(monkeypatch):
    table = _cuda_branch(monkeypatch, _Lib(err=2), 256)
    _cuda.reset_launches()
    with pytest.raises(RuntimeError, match="plan_hist: CUDA error 2"):
        tplan.plan_hist(table, 100, 16, 16)
    assert _cuda.LAUNCHES["plan_hist"] == 0


@pytest.mark.parametrize("z_extent", [64, 1000])
def test_plan_hist_takes_stage1_on_cpu(monkeypatch, z_extent):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_cuda, "lib", no_library)
    table = _clamped_table(700, 1024, 64, z_extent, 8)
    _cuda.reset_launches()
    got = tplan.plan_hist(table, 700, 64, z_extent)
    want = tplan._stage1(table, 700, 64, z_extent)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sum(_cuda.LAUNCHES.values()) == 0
    # the stream on the CPU took neither of the kernel's routes
    rng = np.random.default_rng(2)
    soup = TriangleSoup.from_vertices(rng.random((40, 3, 3), dtype=np.float32))
    slabs = list(engine.voxelize_soup(soup, resolution=16, device="cpu"))
    assert sum(len(xyz) for xyz, _ in slabs) > 0
    assert engine.WAVE_STATS["hist_smem"] == 0
    assert sum(_cuda.LAUNCHES.values()) == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("z_extent", [1024, 64000])
def test_plan_hist_kernel_matches_stage1_on_card(card, z_extent):
    # n_sub not a power of two: live rows end inside a warp and a block
    n_sub, n_pad = 200_003, 1 << 18
    table = _clamped_table(n_sub, n_pad, 512, z_extent, 11).to(card)
    _cuda.reset_launches()
    got = tplan.plan_hist(table, n_sub, 512, z_extent)
    want = tplan._stage1(table, n_sub, 512, z_extent)
    assert _cuda.LAUNCHES["plan_hist"] == 1
    for name, g, w in zip(("per_row", "vmin", "vmax"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
