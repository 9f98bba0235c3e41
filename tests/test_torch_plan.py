"""The port's device planner against the JAX package's host planner.

At group = 1 the order and segments must be bit-identical to
obj2voxel_tpu.ops.plan.plan_mesh, as test_plan_device.py requires of the
JAX device planner.
"""

import dataclasses

import numpy as np
import pytest
import torch

from obj2voxel_tpu.ops.plan import plan_mesh
from obj2voxel_tpu_torch.ops import plan_device as tplan
from obj2voxel_tpu_torch.soup import build_tri_table

torch.set_num_threads(1)


def _random_mesh(n, res, seed):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(0, res, size=(n, 3, 3)).astype(np.float32)
    small = rng.random(n) < 0.7
    verts[small, 1:, :] = verts[small, :1, :] + rng.uniform(
        -2, 2, size=(int(small.sum()), 2, 3)
    ).astype(np.float32)
    return verts


def _plans(n, res, slot_budget, seed, n_pad=None):
    verts = _random_mesh(n, res, seed)
    clamp_hi = np.array([res, res, res], np.float32)
    vmin = np.clip(np.floor(verts.min(axis=1)), 0, clamp_hi).astype(np.int64)
    vmax = np.clip(np.floor(verts.max(axis=1)) + 1, 0, clamp_hi).astype(np.int64)
    n_pad = n_pad or 1 << max(8, (n - 1).bit_length())
    table = build_tri_table(
        verts, np.zeros((n, 3, 2), np.float32), np.ones(n, np.int32),
        np.ones((n, 3), np.float32), np.full(n, -1, np.int32), n_pad=n_pad,
    )
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
    table = build_tri_table(
        verts, np.zeros((n, 3, 2), np.float32), np.ones(n, np.int32),
        np.ones((n, 3), np.float32), np.full(n, -1, np.int32), n_pad=4096,
    )
    got = tplan.plan_mesh_device(torch.from_numpy(table), n, 64, z_extent, 1 << 8)
    assert got == (None, None)


def test_plan_empty_mesh():
    table = np.zeros((256, 24), np.float32)
    assert tplan.plan_mesh_device(torch.from_numpy(table), 0, 16, 16, 1 << 12) == (None, [])
