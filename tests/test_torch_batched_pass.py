"""K1's batched form (`fused_pass_batch`) on the CPU, where its wrapper takes
the plain version `fused_pass_batch_ref`.

- The batched plain version equals one `fused_pass_ref` a pass bit for bit,
  at expand 8 and 512, with z windows and short `n_rows`
  (tests/test_pass_fused.py's batched case, on the port's side); and, on
  each pass's counts and live rows only (the wrapper's contract: the kernel
  leaves the rows past a count undefined), for every batch size 2 to 8 with
  a pass that has no live pair.
- `stream_slabs` reads nothing of a batched pass past its count: with every
  row past each count poisoned (random keys, NaN channels),
  tests/test_pipeline.py:160's soup under O2V_BATCH=8 gives the bytes of
  the clean run, BLEND, and MAX supersampled (`do_down`).
- It agrees with the JAX package's `_bucket_pass_batch(use_pallas=False)`,
  whose Pallas kernel XLA compiles for the CPU in interpret mode (one
  compile, some 40 s; tests/fixtures/jax_batched_pass.npz holds its
  outputs, scripts/jax_test_references.py writes them): keys and live
  counts exactly, channels to rtol 5e-5
  and atol 1e-5, the JAX test's own tolerance.  The JAX kernel packs each
  8192-slot block's live pairs into whole 128-slot rows
  (ops/pack_pallas.py `flush_packed`), so its count is a multiple of 128
  and (INVALID, 0) rows sit between the blocks' pairs; dropped, the rest
  is the port's exact compaction, in the same slot order.  The
  interpret-mode program contracts multiply-adds into FMAs
  (tests/test_torch_fused_textured.py), so this comparison runs on an 8^3
  grid.
- The wrapper takes the plain version for CPU tensors and counts no launch;
  on its CUDA branch (meta tensors, a stand-in library) it makes one call
  with the per-pass scalars on the host, in one buffer of the outputs and
  the look-back's status words and ticket, counts one launch, and raises on
  a non-zero error code instead of falling back.
- `_check` rejects 0 or more than 8 passes, mixed strides and every pass
  that `fused_pass` rejects.
"""

import numpy as np
import pytest
import torch

from jax_reference import reference
import obj2voxel_tpu_torch as pt
from obj2voxel_tpu_torch import engine
from obj2voxel_tpu_torch.constants import BLEND_STRATEGY, MAX_STRATEGY
from obj2voxel_tpu_torch.ops import _cuda, pass_fused
from obj2voxel_tpu_torch.ops.pass_fused import (
    MAX_BATCH, fused_pass, fused_pass_batch, fused_pass_batch_ref,
    fused_pass_ref,
)
from obj2voxel_tpu_torch.soup import build_tri_table

torch.set_num_threads(1)

BUDGET = 1 << 14
B = 4
INV = (1 << 31) - 1


def _table(n, res, aabb_span, seed):
    """(n, 24) untextured rows: random triangles up to `aabb_span` voxels
    wide inside [1, res - 1)^3 (tests/test_pass_fused.py `_table`)."""
    rng = np.random.RandomState(seed)
    verts = rng.uniform(1, res - 1 - aabb_span, size=(n, 3, 3)).astype(np.float32)
    verts[:, 1:, :] = verts[:, :1, :] + rng.uniform(
        -aabb_span, aabb_span, size=(n, 2, 3)).astype(np.float32)
    uvs = np.zeros((n, 3, 2), np.float32)
    return build_tri_table(verts, uvs, np.ones(n, np.int32),
                           rng.rand(n, 3).astype(np.float32),
                           np.full(n, -1, np.int32))


def _passes(rows, res, n_rows=None):
    """B passes over consecutive row windows of `rows` rows, each in its own
    z slab of the grid; the second and fourth pass run short."""
    n_rows = n_rows or [rows, rows - 5, rows, rows - 1]
    h = res // B
    return [(b * rows, n_rows[b], 0, b * h, (b + 1) * h, res) for b in range(B)]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("expand,span", [(8, 1.2), (512, 6.0)])
@pytest.mark.parametrize("ref_weights", [False, True])
def test_plain_batch_equals_single_passes(expand, span, ref_weights):
    rows, res = BUDGET // expand, 64
    table = torch.from_numpy(_table(B * rows + 32, res, span, 100 + expand))
    passes = _passes(rows, res)
    got = fused_pass_batch(table, passes, expand=expand, budget=BUDGET,
                           ref_weights=ref_weights)
    assert [tuple(x.shape) for x in got] == [(B, BUDGET)] * 5 + [(B,)]
    assert got[0].dtype == got[5].dtype == torch.int32
    covered = 0
    for b, p in enumerate(passes):
        want = fused_pass_ref(table, *p, expand=expand, budget=BUDGET,
                              wide_local=False, ref_weights=ref_weights)
        assert int(got[5][b]) == int(want[5])
        for g, w in zip(got[:5], want[:5]):
            assert torch.equal(_bits(g[b]), _bits(w))
        covered += int(want[5])
    assert covered > 0


@pytest.mark.parametrize("nb", range(2, MAX_BATCH + 1))
def test_plain_batch_live_rows_equal_single_passes(nb):
    expand, budget, res = 8, 4096, 64
    rows = budget // expand
    table = torch.from_numpy(_table(nb * rows + 32, res, 1.2, 200 + nb))
    h = res // nb
    passes = [(b * rows, rows - b, 0, b * h, (b + 1) * h, res) for b in range(nb)]
    # the middle pass in an empty z window: no live pair
    e = nb // 2
    passes[e] = (*passes[e][:3], 0, 0, res)
    got = fused_pass_batch(table, passes, expand=expand, budget=budget)
    counts = got[5].tolist()
    assert counts[e] == 0 and sum(counts) > 0
    for b, p in enumerate(passes):
        want = fused_pass(table, *p, expand=expand, budget=budget)
        n = int(want[5])
        assert counts[b] == n
        for g, w in zip(got[:5], want[:5]):
            assert torch.equal(_bits(g[b, :n]), _bits(w[:n]))


def _pipeline_soup():
    """tests/test_pipeline.py:160's soup: 6000 translated copies of one
    triangle at integer offsets, one expand bucket, several passes a slab at
    a 2^14 budget."""
    rng = np.random.RandomState(7)
    base = np.array([[0.2, 0.2, 0.3], [1.4, 0.3, 0.4], [0.3, 1.4, 1.3]], np.float32)
    offs = rng.randint(0, 60, size=(6000, 1, 3)).astype(np.float32)
    return pt.TriangleSoup.from_vertices((base[None] + offs).reshape(-1, 3, 3))


def _stream_bytes(soup, **kw):
    out = list(pt.voxelize_soup(
        soup, resolution=64, pair_tile=1 << 14, device="cpu",
        bounds=(np.zeros(3, np.float32), np.full(3, 62.0, np.float32)), **kw))
    assert out
    return b"".join([x.tobytes() for x, _ in out] + [a.tobytes() for _, a in out])


@pytest.mark.parametrize("strategy,supersampling", [(BLEND_STRATEGY, 1),
                                                    (MAX_STRATEGY, 2)],
                         ids=["blend", "max_do_down"])
def test_stream_reads_nothing_past_a_count(monkeypatch, strategy, supersampling):
    for name in ("O2V_WAVE_CAP", "O2V_HOST_PLAN", "O2V_GROUP"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("O2V_BATCH", "8")
    monkeypatch.setenv("O2V_BATCH_FORCE", "1")
    soup = _pipeline_soup()
    kw = dict(strategy=strategy, supersampling=supersampling)
    want = _stream_bytes(soup, **kw)
    clean = pass_fused.fused_pass_batch_ref
    poisoned = []

    def poison(table, passes, *, expand, budget, ref_weights=False):
        out = clean(table, passes, expand=expand, budget=budget,
                    ref_weights=ref_weights)
        gen = torch.Generator().manual_seed(len(poisoned))
        for b, n in enumerate(out[5].tolist()):
            out[0][b, n:] = torch.randint(0, 1 << 18, (budget - n,), generator=gen,
                                          dtype=torch.int32)
            for c in out[1:5]:
                c[b, n:] = float("nan")
            poisoned.append(budget - n)
        return out

    monkeypatch.setattr(pass_fused, "fused_pass_batch_ref", poison)
    assert _stream_bytes(soup, **kw) == want
    assert engine.WAVE_STATS["batched"] >= 2 and sum(poisoned) > 0


#: the JAX comparison's pass: (expand, res, budget)
JAX_PASS = (8, 8, 8192)


def jax_pass_inputs():
    """The JAX comparison's table and its passes' five int32 columns."""
    expand, res, budget = JAX_PASS
    rows = budget // expand
    table_np = _table(B * rows + 32, res, 1.2, 3)
    passes = _passes(rows, res)
    cols = [np.array([p[j] for p in passes], np.int32) for j in range(5)]
    return table_np, passes, cols


def test_plain_batch_matches_jax_bucket_pass_batch():
    expand, res, budget = JAX_PASS
    table_np, passes, cols = jax_pass_inputs()
    got = fused_pass_batch(torch.from_numpy(table_np), passes, expand=expand,
                           budget=budget)
    ref = reference("batched_pass", "bucket_pass_batch", table_np, *cols,
                    res=res, expand=expand, budget=budget, nbatch=B)
    keys, counts = ref["keys"], ref["counts"]
    chans = [ref[f"chan{j}"] for j in range(4)]
    assert int(got[5].sum()) > 0
    for b in range(B):
        n = int(got[5][b])
        live = keys[b] != INV
        assert not live[counts[b]:].any()
        assert int(live.sum()) == n
        np.testing.assert_array_equal(got[0][b, :n].numpy(), keys[b][live])
        assert bool((got[0][b, n:] == INV).all())
        for g, w in zip(got[1:5], chans):
            np.testing.assert_allclose(g[b, :n].numpy(), w[b][live],
                                       rtol=5e-5, atol=1e-5)
            assert bool((g[b, n:] == 0).all())


def test_wrapper_takes_plain_version_on_cpu():
    table = torch.from_numpy(_table(B * 128, 16, 1.2, 5))
    passes = _passes(128, 16)
    _cuda.reset_launches()
    got = fused_pass_batch(table, passes, expand=8, budget=1024)
    want = fused_pass_batch_ref(table, passes, expand=8, budget=1024)
    assert _cuda.LAUNCHES["fused_pass"] == 0
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))
    # one pass alone is `fused_pass`'s output
    one = fused_pass_batch(table, passes[2:3], expand=8, budget=1024)
    single = fused_pass(table, *passes[2], expand=8, budget=1024)
    assert all(torch.equal(_bits(g[0]), _bits(w))
               for g, w in zip(one[:5], single[:5]))
    assert int(one[5][0]) == int(single[5])


class _Lib:
    """A stand-in kernel library that records its calls."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def o2v_fused_pass(self, *args):
        self.calls.append(args)
        return self.err

    def o2v_error_string(self, err):
        return b"stand-in error"


def _cuda_branch(monkeypatch, lib):
    monkeypatch.setattr(_cuda, "lib", lambda: lib)
    monkeypatch.setattr(_cuda, "require_cuda", lambda name, *t: t[0].device)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda dev: 0)
    return torch.zeros((64, 24), device="meta")


def test_wrapper_cuda_branch_layout(monkeypatch):
    # meta tensors: every pointer is its offset into the tensor's storage
    lib = _Lib()
    table = _cuda_branch(monkeypatch, lib)
    passes = [(0, 32, 0, 0, 4, 8), (32, 30, 0, 4, 8, 8), (8, 4, 0, 2, 6, 8)]
    _cuda.reset_launches()
    budget, nb = 1024, len(passes)
    key, w, r, g, b, counts = fused_pass_batch(table, passes, expand=8,
                                               budget=budget, ref_weights=True)
    assert _cuda.LAUNCHES["fused_pass"] == len(lib.calls) == 1
    args = lib.calls[0]
    size = nb * budget
    assert key.shape == w.shape == (nb, budget) and counts.shape == (nb,)
    assert list(args[:6]) == [4 * i * size for i in range(6)]
    assert [4 * x.storage_offset() for x in (key, w, r, g, b, counts)] == list(args[:6])
    # no slot-ordered scratch: after the outputs, 8-byte aligned, one status
    # word a (pass, tile) and the ticket, in the same buffer
    tiles = budget // _cuda.COMPACT_TILE
    head = 5 * size + nb + 1
    assert args[6] == 4 * head and args[6] % 8 == 0
    assert key.untyped_storage().nbytes() == 4 * head + 8 * (nb * tiles + 1)
    scal = args[9]
    assert list(scal) == [x for p in passes for x in p[:5]]
    # B, stride, log2 expand, budget, wide_local, ref_weights, textured,
    # stream
    assert args[10:18] == (nb, 8, 3, budget, 0, 1, 0, 0)


def test_wrapper_raises_on_a_failed_launch(monkeypatch):
    table = _cuda_branch(monkeypatch, _Lib(err=2))
    _cuda.reset_launches()
    with pytest.raises(RuntimeError, match="fused_pass_batch: CUDA error 2"):
        fused_pass_batch(table, [(0, 8, 0, 0, 8, 8)] * 2, expand=8, budget=1024)
    assert _cuda.LAUNCHES["fused_pass"] == 0


GOOD = (0, 16, 0, 0, 8, 8)


@pytest.mark.parametrize("passes,kw,match", [
    ([], {}, "0 passes"),
    ([GOOD] * (MAX_BATCH + 1), {}, "9 passes"),
    ([GOOD, (0, 16, 0, 0, 8, 16)], {}, "mix strides"),
    ([GOOD[:5]], {}, "is \\(r0, n_rows"),
    ([GOOD, (0, 16, 0, 0, 8, 8)], {"budget": 1001}, "bad expand"),
    ([GOOD, (0, 200, 0, 0, 8, 8)], {}, "exceed the budget"),
    ([GOOD, (60, 16, 0, 0, 8, 8)], {}, "outside the table"),
    ([GOOD, (0, 16, 0, 6, 4, 8)], {}, "bad slab bounds"),
    ([(0, 16, 0, 0, 1 << 10, 1 << 11)], {}, "overflow int32"),
    ([GOOD, (0, 16, (1 << 23) - 4, 0, 8, 8)], {}, "ranks < 2\\^23"),
    ([GOOD, (0, 16, -1, 0, 8, 8)], {}, "slot rank overflows"),
])
def test_check_rejects(passes, kw, match):
    table = torch.zeros((64, 24))
    with pytest.raises(ValueError, match=match):
        fused_pass_batch(table, passes, **{"expand": 8, "budget": 1024, **kw})


def test_check_rejects_a_bad_table():
    with pytest.raises(ValueError, match="table must be"):
        fused_pass_batch(torch.zeros((64, 24), dtype=torch.float64), [GOOD],
                         expand=8, budget=1024)
