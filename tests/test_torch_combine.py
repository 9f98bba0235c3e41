"""K2's and combine_pack's plain versions and the port's combine ops
against the JAX package.

The JAX oracle is obj2voxel_tpu.ops.combine.combine_sorted (stable sort +
associative scan + tail compaction), the same oracle the Pallas kernel is
held to in test_combine_pallas.py.  MAX must match exactly (ties keep the
earliest element); BLEND sums to rtol 1e-6 (another summation order).  The
oracle's outputs are those of tests/fixtures/jax_combine.npz
(scripts/jax_test_references.py).
"""

import numpy as np
import pytest
import torch

from jax_reference import reference
from obj2voxel_tpu_torch.ops import combine as tcomb
from obj2voxel_tpu_torch.engine import _combine_presorted
from obj2voxel_tpu_torch.ops.combine_pallas import (
    combine_pack,
    segment_combine,
    segment_combine_ref,
)
from obj2voxel_tpu_torch.ops.pack_pallas import pack_exact_ref

torch.set_num_threads(1)

INV = (1 << 31) - 1


def _stream(seed, n_keys, p=4096):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, p).astype(np.int32)
    keys[rng.random(p) < 0.1] = INV
    w = (rng.random(p) + 0.01).astype(np.float32)
    w[rng.random(p) < 0.2] = 0.0
    # quantized weights: MAX ties are common
    w = np.where(w > 0, np.ceil(w * 4) / 4, 0.0).astype(np.float32)
    rgb = rng.random((p, 3), dtype=np.float32)
    keys = np.where(w > 0, keys, INV).astype(np.int32)
    return keys, w, rgb


def _jax_combined(case, keys, w, rgb, is_blend):
    """The oracle's live keys and (w, r, g, b) rows of the stream."""
    ref = reference("combine", case, keys, w, rgb, is_blend=is_blend)
    return ref["keys"], ref["vals"]


def _tag(is_blend):
    return "blend" if is_blend else "max"


def _tie_stream():
    """Two rows of key 7 with equal weights, red first."""
    keys = np.full(64, INV, np.int32)
    w = np.zeros(64, np.float32)
    rgb = np.zeros((64, 3), np.float32)
    keys[3] = keys[9] = 7
    w[3] = w[9] = 0.5
    rgb[3] = [1.0, 0.0, 0.0]
    rgb[9] = [0.0, 1.0, 0.0]
    return keys, w, rgb


def _single_run(p=4096):
    keys = np.zeros(p, np.int32)
    w = np.full(p, 0.25, np.float32)
    rgb = np.tile(np.asarray([[0.2, 0.4, 0.8]], np.float32), (p, 1))
    return keys, w, rgb


def finalize_inputs():
    """(w, rgb) of the finalize-and-pack case."""
    rng = np.random.default_rng(9)
    p = 2000
    w = rng.random(p, dtype=np.float32) * 3
    w[:50] = 0.0
    rgb = rng.random((p, 3), dtype=np.float32)
    # exact quantization boundaries (Kd 0.1 -> byte 26 needs an exact divide)
    rgb[50:60] = 0.1
    rgb[60:70] = 0.5 / 255.0
    return w, rgb


def combined_cases():
    """Every oracle case: name -> ((keys, w, rgb), is_blend)."""
    cases = {"tie": (_tie_stream(), False)}
    for is_blend in (True, False):
        tag = _tag(is_blend)
        for n_keys in (3, 50, 4096):
            cases[f"segment_{n_keys}_{tag}"] = (_stream(42, n_keys), is_blend)
        cases[f"combine_sorted_{tag}"] = (_stream(7, 600, p=8192), is_blend)
        cases[f"single_run_{tag}"] = (_single_run(), is_blend)
        for c in COMBINE_PACK_CASES:
            cases[f"combine_pack_{c}_{tag}"] = (_combine_pack_case(c), is_blend)
    return cases


def _port_sorted(keys, w, rgb):
    chans = tcomb.premultiply(torch.from_numpy(w), torch.from_numpy(rgb))
    return tcomb.sort_channels(torch.from_numpy(keys), chans)


def _check(got_k, got_v, want_k, want_v, is_blend):
    np.testing.assert_array_equal(got_k, want_k)
    if is_blend:
        np.testing.assert_allclose(got_v, want_v, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got_v, want_v)


@pytest.mark.parametrize("is_blend", [True, False], ids=["blend", "max"])
@pytest.mark.parametrize("n_keys", [3, 50, 4096])
def test_segment_combine_plain_matches_jax(is_blend, n_keys):
    keys, w, rgb = _stream(42, n_keys)
    want_k, want_v = _jax_combined(f"segment_{n_keys}_{_tag(is_blend)}", keys, w,
                                   rgb, is_blend)
    sk, sch = _port_sorted(keys, w, rgb)
    tk, *tv = segment_combine_ref(sk, *sch, is_blend)
    # compact by the tail marks (order-preserving)
    live = tk != INV
    got_v = torch.stack([c[live] for c in tv], -1).numpy()
    _check(tk[live].numpy(), got_v, want_k, want_v, is_blend)
    # every other slot is (INVALID, 0)
    for c in tv:
        assert bool((c[~live] == 0).all())


@pytest.mark.parametrize("is_blend", [True, False], ids=["blend", "max"])
def test_combine_sorted_matches_jax(is_blend):
    keys, w, rgb = _stream(7, 600, p=8192)
    want_k, want_v = _jax_combined(f"combine_sorted_{_tag(is_blend)}", keys, w, rgb,
                                   is_blend)
    sk, sch = _port_sorted(keys, w, rgb)
    ok, och, oc = tcomb.combine_sorted(sk, sch, is_blend)
    n = int(oc)
    assert n == want_k.size
    got_v = torch.stack([c[:n] for c in och], -1).numpy()
    _check(ok[:n].numpy(), got_v, want_k, want_v, is_blend)
    assert bool((ok[n:] == INV).all())
    assert all(bool((c[n:] == 0).all()) for c in och)


def test_max_tie_keeps_earliest():
    keys, w, rgb = _tie_stream()
    want_k, want_v = _jax_combined("tie", keys, w, rgb, False)
    sk, sch = _port_sorted(keys, w, rgb)
    tk, *tv = segment_combine_ref(sk, *sch, False)
    live = tk != INV
    got_v = torch.stack([c[live] for c in tv], -1).numpy()
    _check(tk[live].numpy(), got_v, want_k, want_v, False)
    np.testing.assert_array_equal(got_v[0], [0.5, 0.5, 0.0, 0.0])


@pytest.mark.parametrize("is_blend", [True, False], ids=["blend", "max"])
def test_single_run_spanning_everything(is_blend):
    keys, w, rgb = _single_run()
    want_k, want_v = _jax_combined(f"single_run_{_tag(is_blend)}", keys, w, rgb,
                                   is_blend)
    sk, sch = _port_sorted(keys, w, rgb)
    tk, *tv = segment_combine(sk, *sch, is_blend)
    assert int((tk != INV).sum()) == 1 and int(tk[-1]) == 0
    got_v = torch.stack([c[-1:] for c in tv], -1).numpy()
    _check(tk[-1:].numpy(), got_v, want_k, want_v, is_blend)


def test_segment_combine_empty_stream():
    e = torch.zeros(0, dtype=torch.float32)
    out = segment_combine(torch.zeros(0, dtype=torch.int32), e, e, e, e, True)
    assert all(o.numel() == 0 for o in out)


def test_finalize_and_pack_argb_match_jax():
    w, rgb = finalize_inputs()
    want = reference("combine", "finalize_pack_argb", w, rgb)["argb"]
    tchans = tcomb.premultiply(torch.from_numpy(w), torch.from_numpy(rgb))
    got = tcomb.pack_argb(tcomb.finalize_colors(tchans))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sort_channels_is_stable():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 5, 1000).astype(np.int32)
    pos = np.arange(1000, dtype=np.float32)
    sk, (p0, *_rest) = tcomb.sort_channels(
        torch.from_numpy(keys), (torch.from_numpy(pos),) * 4
    )
    want = np.argsort(keys, kind="stable").astype(np.float32)
    np.testing.assert_array_equal(p0.numpy(), want)
    np.testing.assert_array_equal(sk.numpy(), np.sort(keys))


COMBINE_PACK_CASES = ["keys3", "keys50", "keys4096", "one_run", "all_invalid"]


def _combine_pack_case(case):
    """(keys, w, rgb) of `_stream`'s shape (p = 4096) for each case."""
    if case.startswith("keys"):
        return _stream(11, int(case[4:]))
    p = 4096
    w = np.full(p, 0.25, np.float32)
    rgb = np.tile(np.asarray([[0.2, 0.4, 0.8]], np.float32), (p, 1))
    keys = np.zeros(p, np.int32) if case == "one_run" else np.full(p, INV, np.int32)
    return keys, w, rgb


@pytest.mark.parametrize("is_blend", [True, False], ids=["blend", "max"])
@pytest.mark.parametrize("case", COMBINE_PACK_CASES)
def test_combine_pack_plain_matches_jax(is_blend, case):
    # combine_pack on the CPU (its plain version) against the oracle the
    # Pallas composition `_combine_sorted_kernel` is held to
    keys, w, rgb = _combine_pack_case(case)
    want_k, want_v = _jax_combined(f"combine_pack_{case}_{_tag(is_blend)}", keys, w,
                                   rgb, is_blend)
    sk, sch = _port_sorted(keys, w, rgb)
    ok, och, oc = combine_pack(sk, sch, is_blend)
    n = int(oc)
    assert oc.dtype == torch.int32 and oc.shape == (1,) and n == want_k.size
    got_v = torch.stack([c[:n] for c in och], -1).numpy()
    _check(ok[:n].numpy(), got_v, want_k, want_v, is_blend)
    assert bool((ok[n:] == INV).all())
    assert all(bool((c[n:] == 0).all()) for c in och)


def test_combine_pack_empty_stream():
    e = torch.zeros(0, dtype=torch.float32)
    ok, och, oc = combine_pack(torch.zeros(0, dtype=torch.int32), (e,) * 4, True)
    assert ok.numel() == 0 and all(c.numel() == 0 for c in och)
    assert oc.dtype == torch.int32 and int(oc) == 0


@pytest.mark.parametrize("is_blend", [True, False], ids=["blend", "max"])
def test_combine_presorted_is_the_plain_chain(is_blend):
    # the engine's merge tail equals K2's plain version then K3's, exactly
    keys, w, rgb = _stream(5, 50)
    sk, sch = _port_sorted(keys, w, rgb)
    got = _combine_presorted(sk, sch, is_blend)
    tk, *tv = segment_combine_ref(sk, *sch, is_blend)
    want = pack_exact_ref(tk, tuple(tv))
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
