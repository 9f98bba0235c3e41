"""The port's device planner against the JAX package's host planner.

At group = 1 the order and segments must be bit-identical to
obj2voxel_tpu.ops.plan.plan_mesh, as test_plan_device.py requires of the
JAX device planner.  The wrappers of both stages are checked here too:
`plan_hist` (stage 1) and `plan_order` (stage 2), each CUDA branch against
a stand-in kernel library, and (marked `card`) the kernels against the
plain `_stage1` and `_stage2` on a card.  The JAX package is imported
only where a test compares with it, so the `card` tests also run where JAX
is not installed:

    python -m pytest tests/test_torch_plan.py -m card --noconftest
"""

import ctypes
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


# 2^k - 1, 2^k and 2^k + 1 for k up to 40, besides the first cases
_LOG2_CASES = [0, 1, 2, 3, 4, 5, 1023, 1024, 1025, (1 << 31) - 1]
_LOG2_CASES += sorted({(1 << k) + d for k in range(2, 41) for d in (-1, 0, 1)}
                      - set(_LOG2_CASES))


@pytest.mark.parametrize("c", _LOG2_CASES)
def test_ceil_log2_exact(c):
    # the plain version's frexp exponent against the bit length of c - 1,
    # which plan_keys takes as 64 - __clzll(c - 1)
    k = int(tplan._ceil_log2(torch.tensor([c], dtype=torch.int64))[0])
    want = 0 if c <= 1 else 64 - (64 - (c - 1).bit_length())
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


# --- stage 2's wrapper: plan_order --------------------------------------------


def _host_array(ptr, ctype, n):
    """A numpy view of n `ctype`s at a host address (a CPU tensor's or a
    numpy array's data)."""
    if n == 0:
        return np.zeros(0, np.dtype(ctype))
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


class _OrderLib:
    """A stand-in for csrc/plan_keys.cu over CPU tensors: it records each
    call and does what the kernels' contract says, warp by warp, so the
    wrapper's layouts, partition and scan are held to the plain `_stage2`.
    Keys come from the plain `_stage2_keys` (the arithmetic is the card's
    to check); the layouts and the ranking are the model's."""

    def __init__(self, keys_err=0, scatter_err=0):
        self.keys_calls, self.scatter_calls = [], []
        self.keys_err, self.scatter_err = keys_err, scatter_err

    def o2v_plan_keys(self, vmin, vmax, keys, counts, n_act, n_sub, group,
                      s_pad, n_slabs, starts, stops, units, chunk, stream):
        lo = _host_array(starts, ctypes.c_int32, s_pad).copy()
        hi = _host_array(stops, ctypes.c_int32, s_pad).copy()
        self.keys_calls.append(dict(
            n_act=n_act, n_sub=n_sub, group=group, s_pad=s_pad,
            n_slabs=n_slabs, starts=lo, stops=hi, units=units, chunk=chunk))
        if self.keys_err:
            return self.keys_err
        rows = n_act * group
        to_t = lambda p: torch.from_numpy(
            _host_array(p, ctypes.c_int32, rows * 3).reshape(rows, 3).copy())
        key = tplan._stage2_keys(to_t(vmin), to_t(vmax), n_sub,
                                 torch.from_numpy(lo.astype(np.int64)),
                                 torch.from_numpy(hi.astype(np.int64)),
                                 n_slabs, s_pad, group).numpy()
        out = _host_array(keys, ctypes.c_uint16, s_pad * n_act)
        out[:] = key.T.reshape(-1)  # slab-major
        n_bins = s_pad * 64
        cnt = _host_array(counts, ctypes.c_int32, n_bins * units).reshape(n_bins, units)
        for u in range(units):
            part = key[u * chunk:(u + 1) * chunk].reshape(-1)
            cnt[:, u] = np.bincount(part, minlength=n_bins + 1)[:n_bins]
        return 0

    def o2v_plan_scatter(self, keys, counts, inclusive, order, n_act, s_pad,
                         units, chunk, stream):
        self.scatter_calls.append(dict(n_act=n_act, s_pad=s_pad, units=units,
                                       chunk=chunk))
        if self.scatter_err:
            return self.scatter_err
        n_bins = s_pad * 64
        key = _host_array(keys, ctypes.c_uint16, s_pad * n_act).reshape(s_pad, n_act)
        cnt = _host_array(counts, ctypes.c_int32, n_bins * units).reshape(n_bins, units)
        inc = _host_array(inclusive, ctypes.c_int32, n_bins * units).reshape(n_bins, units)
        total = int(inc[-1, -1])
        out = _host_array(order, ctypes.c_int64, total)
        for u in range(units):
            run = inc[:, u] - cnt[:, u]  # the warp's first position a bin
            for g in range(u * chunk, min((u + 1) * chunk, n_act)):
                for s in range(s_pad):
                    b = int(key[s, g])
                    if b < n_bins:
                        out[run[b]] = g
                        run[b] += 1
        return 0

    def o2v_error_string(self, err):
        return b"stand-in error"


def _order_inputs(n_sub, n_pad, z_extent, n_slabs, s_pad, z_window=None, seed=21):
    """(vmin, vmax) of a clamped random table and slabs like the planner's:
    n_slabs even slabs tiling [0, z_extent) or the window, padded to s_pad
    with z_extent."""
    table = _clamped_table(n_sub, n_pad, 64, z_extent, seed)
    _, vmin, vmax = tplan._stage1(table, n_sub, 64, z_extent)
    z0, z1 = z_window or (0, z_extent)
    cuts = np.linspace(z0, z1, n_slabs + 1).astype(np.int64)
    starts, stops = tplan.slab_rows(list(zip(cuts[:-1], cuts[1:])), z_extent)
    assert len(starts) == s_pad
    return vmin, vmax, starts, stops


def _order_branch(monkeypatch, lib, warps):
    """`plan_order`'s CUDA branch on CPU tensors, `lib` in place of the
    kernel library, at most `warps` warps."""
    monkeypatch.setattr(_cuda, "lib", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(tplan, "ORDER_WARPS", warps)


def _assert_prefix_equal(got, want):
    (order, bounds), (w_order, w_bounds) = got, want
    assert bounds.device.type == "cpu" and bounds.dtype == torch.int64
    assert torch.equal(bounds, w_bounds)
    total = int(w_bounds[-1])
    assert order.dtype == torch.int64 and order.shape == (total,)
    assert torch.equal(order, w_order[:total])


@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("s_pad", [1, 2, 4, 8, 16, 32])
def test_plan_order_wrapper_matches_stage2(monkeypatch, s_pad, group):
    # n_sub not a multiple of the group: the last live group holds padding
    n_sub, n_pad, z_extent = 1501, 2048, 96
    n_slabs = s_pad // 2 + 1
    vmin, vmax, starts, stops = _order_inputs(n_sub, n_pad, z_extent, n_slabs, s_pad)
    lib = _OrderLib()
    _order_branch(monkeypatch, lib, 5)
    _cuda.reset_launches()
    got = tplan._order_kernels(vmin, vmax, n_sub, starts, stops, n_slabs, group,
                               vmin.device)
    want = tplan._stage2(vmin, vmax, n_sub, torch.from_numpy(starts),
                         torch.from_numpy(stops), n_slabs, s_pad, group)
    _assert_prefix_equal(got, want)
    assert _cuda.LAUNCHES["plan_keys"] == len(lib.keys_calls) == 1
    assert _cuda.LAUNCHES["plan_scatter"] == len(lib.scatter_calls) == 1
    assert sum(_cuda.LAUNCHES.values()) == 2
    call = lib.keys_calls[0]
    n_act = -(-n_sub // group)
    assert (call["n_act"], call["n_sub"], call["group"], call["s_pad"],
            call["n_slabs"]) == (n_act, n_sub, group, s_pad, n_slabs)
    np.testing.assert_array_equal(call["starts"], starts)
    np.testing.assert_array_equal(call["stops"], stops)
    # every group in exactly one warp's range, each a whole number of rounds
    units, chunk = call["units"], call["chunk"]
    assert (units, chunk) == tplan.order_units(n_act)
    assert 1 <= units <= 5 and chunk % 32 == 0
    assert (units - 1) * chunk < n_act <= units * chunk
    assert lib.scatter_calls[0] == dict(n_act=n_act, s_pad=s_pad, units=units,
                                        chunk=chunk)


@pytest.mark.parametrize("case", ["z-window", "all-dead", "one-group"])
def test_plan_order_wrapper_edges(monkeypatch, case):
    n_sub, n_pad, z_extent, s_pad, n_slabs = 700, 1024, 64, 4, 3
    window = (16, 40) if case == "z-window" else None
    vmin, vmax, starts, stops = _order_inputs(n_sub, n_pad, z_extent, n_slabs,
                                              s_pad, window)
    if case == "all-dead":
        vmax[:, 0] = vmin[:, 0]  # no row spans x
    if case == "one-group":
        n_sub = 5  # fewer live rows than one group
    lib = _OrderLib()
    _order_branch(monkeypatch, lib, 3)
    _cuda.reset_launches()
    got = tplan._order_kernels(vmin, vmax, n_sub, starts, stops, n_slabs, 8,
                               vmin.device)
    want = tplan._stage2(vmin, vmax, n_sub, torch.from_numpy(starts),
                         torch.from_numpy(stops), n_slabs, s_pad, 8)
    _assert_prefix_equal(got, want)
    total = int(want[1][-1])
    assert (total == 0) is (case == "all-dead")
    assert _cuda.LAUNCHES["plan_keys"] == 1
    # no live incidence: nothing to scatter
    assert _cuda.LAUNCHES["plan_scatter"] == int(total > 0)


@pytest.mark.parametrize("n_act", [0, 1, 31, 32, 33, 4095 * 32, 4096 * 32 + 1,
                                   1_249_924, 1 << 28])
def test_order_units_cover_the_groups(n_act):
    units, chunk = tplan.order_units(n_act)
    assert 1 <= units <= tplan.ORDER_WARPS and chunk >= 32 and chunk % 32 == 0
    assert (units - 1) * chunk < max(n_act, 1) <= units * chunk


def test_plan_order_raises_on_a_failed_launch(monkeypatch):
    vmin, vmax, starts, stops = _order_inputs(300, 512, 32, 2, 2)
    for lib, what, keys_n in ((_OrderLib(keys_err=2), "plan_keys", 0),
                              (_OrderLib(scatter_err=3), "plan_scatter", 1)):
        _order_branch(monkeypatch, lib, 4)
        _cuda.reset_launches()
        with pytest.raises(RuntimeError, match=f"{what}: CUDA error"):
            tplan._order_kernels(vmin, vmax, 300, starts, stops, 2, 1, vmin.device)
        assert _cuda.LAUNCHES["plan_keys"] == keys_n
        assert _cuda.LAUNCHES["plan_scatter"] == 0


@pytest.mark.parametrize("bad", ["int64", "misaligned", "s_pad-3", "group-3",
                                 "no-slabs"])
def test_plan_order_refuses_what_the_kernels_do_not_take(monkeypatch, bad):
    vmin, vmax, starts, stops = _order_inputs(300, 512, 32, 2, 2)
    n_slabs, group = 2, 1
    if bad == "int64":
        vmin = vmin.to(torch.int64)
    if bad == "misaligned":
        vmin = torch.zeros(vmin.numel() + 1, dtype=torch.int32)[1:].view(-1, 3)
    if bad == "s_pad-3":
        starts, stops = np.append(starts, 32), np.append(stops, 32)
    if bad == "group-3":
        group = 3
    if bad == "no-slabs":
        n_slabs = 0
    lib = _OrderLib()
    _order_branch(monkeypatch, lib, 4)
    with pytest.raises(ValueError, match="plan_order"):
        tplan._order_kernels(vmin, vmax, 300, starts, stops, n_slabs, group,
                             vmin.device)
    assert not lib.keys_calls


@pytest.mark.parametrize("group", [1, 8])
def test_plan_order_takes_stage2_on_cpu(monkeypatch, group):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_cuda, "lib", no_library)
    vmin, vmax, starts, stops = _order_inputs(900, 1024, 64, 5, 8)
    _cuda.reset_launches()
    order, bounds = tplan.plan_order(vmin, vmax, 900, starts, stops, 5, group)
    w_order, w_bounds = tplan._stage2(vmin, vmax, 900, torch.from_numpy(starts),
                                      torch.from_numpy(stops), 5, 8, group)
    # the plain order keeps its dead tail
    assert torch.equal(order, w_order) and torch.equal(bounds, w_bounds)
    assert order.shape == (1024 // group * 8,)
    assert sum(_cuda.LAUNCHES.values()) == 0


# --- the kernels on a card ----------------------------------------------------


def _card_order(vmin, vmax, n_sub, starts, stops, n_slabs, group):
    """plan_order's kernels against `_stage2` on the card: the order's live
    prefix and the bounds equal to the last bit; one launch of each kernel
    (none of the scatter without a live incidence)."""
    s_pad = len(starts)
    _cuda.reset_launches()
    order, bounds = tplan.plan_order(vmin, vmax, n_sub, starts, stops, n_slabs,
                                     group)
    torch.cuda.synchronize()
    w_order, w_bounds = tplan._stage2(
        vmin, vmax, n_sub, torch.from_numpy(starts).to(vmin.device),
        torch.from_numpy(stops).to(vmin.device), n_slabs, s_pad, group)
    total = int(w_bounds[-1])
    assert torch.equal(bounds, w_bounds.cpu())
    assert order.shape == (total,) and order.dtype == torch.int64
    assert torch.equal(order, w_order[:total])
    assert _cuda.LAUNCHES["plan_keys"] == 1
    assert _cuda.LAUNCHES["plan_scatter"] == int(total > 0)
    return total


@pytest.mark.card
def test_plan_order_kernels_match_stage2_on_the_10m_sphere(card):
    from obj2voxel_tpu_torch.bench import sphere_table
    from obj2voxel_tpu_torch.ops.expand_bucket import slabs_from_rows

    table_np, _, n_sub = sphere_table(10_000_000, 1024)
    table = torch.from_numpy(table_np).to(card)
    del table_np
    per_row, vmin, vmax = tplan.plan_hist(table, n_sub, 1024, 1024)
    slot_budget = 4 * min(engine.PAIR_TILE, engine.MAX_PASS_BUDGET)
    slabs = slabs_from_rows(per_row.cpu().numpy(), 1024, 1024, slot_budget)
    starts, stops = tplan.slab_rows(slabs, 1024)
    assert len(starts) == 8
    assert _card_order(vmin, vmax, n_sub, starts, stops, len(slabs), 8) > 0


@pytest.mark.card
@pytest.mark.parametrize("s_pad,group,case", [
    (4, 1, "plain"), (4, 2, "plain"), (1, 8, "plain"), (32, 8, "plain"),
    (32, 1, "plain"), (8, 8, "z-window"), (8, 8, "all-dead"),
    (8, 8, "split-group"),
])
def test_plan_order_kernels_match_stage2_on_card(card, s_pad, group, case):
    # n_sub not a multiple of 8 (split-group: of the group) ends the live rows
    # inside a group, a warp's round and a warp's range
    n_sub, n_pad, z_extent = 200_003, 1 << 18, 1024
    n_slabs = s_pad // 2 + 1
    window = (256, 640) if case == "z-window" else None
    vmin, vmax, starts, stops = _order_inputs(n_sub, n_pad, z_extent, n_slabs,
                                              s_pad, window, seed=31)
    if case == "all-dead":
        vmax[:, 1] = vmin[:, 1]
    if case == "split-group":
        n_sub = 200_005
    total = _card_order(vmin.to(card), vmax.to(card), n_sub, starts, stops,
                        n_slabs, group)
    assert (total == 0) is (case == "all-dead")
