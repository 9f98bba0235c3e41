"""The batched passes and the JAX stream's knobs in the port's `stream_slabs`,
on the CPU (O2V_BATCH_FORCE=1 lets the batched path run there, on the
plain version of K1's batched form).

- tests/test_pipeline.py:161's soup (6000 translated copies of one triangle
  at r 64, pair tile 2^14) with O2V_BATCH=8 gives the bytes of O2V_BATCH=1,
  with at least two passes batched and fewer dispatches than passes.
- Against the JAX package's `voxelize_soup` on the same soup at
  O2V_BATCH=8, white and with a random color a copy, MAX and BLEND: the
  same voxels in the same order, MAX colors byte for byte, BLEND within 1
  LSB, and the same WAVE_STATS.  The JAX side runs its batched Pallas kernel
  in interpret mode, jitted (some four minutes on the CPU, one XLA compile
  a batch size), so its outputs are a committed fixture written by
  scripts/jax_batched_reference.py (tests/fixtures/jax_batched_soup.npz),
  held to the soup by a digest.
- Passes of different slabs batch together, and each slab still merges its
  passes in pass order: the same soup with random colors, supersampled
  under MAX (ties between the copies' equal areas), gives the same bytes
  batched and not.
- The five knobs keep the output byte for byte: O2V_WAVE_CAP (one slab a
  wave), O2V_HOST_PLAN=1 (the device planner is not called), O2V_GROUP=1
  (also in parallel/mesh.py's windows) and O2V_MAX_PASS_BUDGET (read at
  import, so in a fresh interpreter); O2V_TIMING=1 prints the JAX package's
  `[o2v-timing]` lines, each wave with its dispatches and batched passes,
  between the port's own lines of the host prep, the table and the pulls,
  and nothing without it.
"""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import obj2voxel_tpu_torch as pt
from obj2voxel_tpu_torch import engine
from obj2voxel_tpu_torch.constants import BLEND_STRATEGY, MAX_STRATEGY, TRI_UNTEXTURED
from obj2voxel_tpu_torch.parallel import mesh

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BOUNDS = (np.zeros(3, np.float32), np.full(3, 62.0, np.float32))
KNOBS = ("O2V_BATCH", "O2V_BATCH_FORCE", "O2V_TIMING", "O2V_WAVE_CAP",
         "O2V_HOST_PLAN", "O2V_GROUP", "O2V_MAX_PASS_BUDGET")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


def _soup(colored=False):
    """tests/test_pipeline.py:161's soup: translated copies of one triangle
    at integer offsets, so that every row lands in one expand bucket and a
    slab needs several passes at a 2^14 budget; `colored` gives each copy
    its own random color."""
    rng = np.random.RandomState(7)
    base = np.array([[0.2, 0.2, 0.3], [1.4, 0.3, 0.4], [0.3, 1.4, 1.3]], np.float32)
    offs = rng.randint(0, 60, size=(6000, 1, 3)).astype(np.float32)
    verts = (base[None] + offs).reshape(-1, 3, 3)
    if not colored:
        return pt.TriangleSoup.from_vertices(verts)
    n = verts.shape[0]
    return pt.TriangleSoup(verts, np.zeros((n, 3, 2), np.float32),
                           np.full(n, TRI_UNTEXTURED, np.int32),
                           rng.rand(n, 3).astype(np.float32),
                           np.full(n, -1, np.int32))


def _bytes(soup, **kw):
    """The port's voxels on the CPU in stream order: every slab's xyz, then
    every slab's ARGB, as one byte string."""
    out = list(pt.voxelize_soup(soup, resolution=64, pair_tile=1 << 14,
                                bounds=BOUNDS, device="cpu", **kw))
    assert out
    return b"".join([x.tobytes() for x, _ in out] + [a.tobytes() for _, a in out])


def _batched(monkeypatch, cap="8"):
    monkeypatch.setenv("O2V_BATCH", cap)
    monkeypatch.setenv("O2V_BATCH_FORCE", "1")


@pytest.mark.parametrize("strategy", [MAX_STRATEGY, BLEND_STRATEGY])
def test_batched_stream_equals_unbatched(monkeypatch, strategy):
    soup = _soup()
    want = _bytes(soup, strategy=strategy)
    assert engine.WAVE_STATS["batched"] == 0
    assert engine.WAVE_STATS["dispatches"] == engine.WAVE_STATS["passes"]
    _batched(monkeypatch)
    assert _bytes(soup, strategy=strategy) == want
    stats = dict(engine.WAVE_STATS)
    assert stats["batched"] >= 2 and stats["dispatches"] < stats["passes"], stats


FIXTURE = Path(__file__).resolve().parent / "fixtures" / "jax_batched_soup.npz"


@pytest.mark.parametrize("case,colored,strategy", [
    ("white_max", False, MAX_STRATEGY),
    ("colored_max", True, MAX_STRATEGY),
    ("colored_blend", True, BLEND_STRATEGY),
])
def test_batched_stream_matches_jax(monkeypatch, case, colored, strategy):
    ref = np.load(FIXTURE)
    soup = _soup(colored)
    digest = hashlib.sha256(soup.verts.tobytes() + soup.rgb.tobytes()).hexdigest()
    assert str(ref[f"{case}_soup"]) == digest, "the fixture is of another soup"
    _batched(monkeypatch)
    out = list(pt.voxelize_soup(soup, resolution=64, pair_tile=1 << 14,
                                bounds=BOUNDS, device="cpu", strategy=strategy))
    xyz = np.concatenate([x for x, _ in out])
    argb = np.concatenate([a for _, a in out])
    stats = engine.WAVE_STATS
    assert [stats["passes"], stats["dispatches"], stats["batched"]] == \
        ref[f"{case}_stats"].tolist()
    np.testing.assert_array_equal(xyz, ref[f"{case}_xyz"])
    lsb = np.abs(argb.view(np.uint8).astype(np.int16)
                 - ref[f"{case}_argb"].view(np.uint8).astype(np.int16)).max()
    assert lsb <= (1 if strategy == BLEND_STRATEGY else 0)


def test_batching_needs_a_cuda_device_or_force(monkeypatch):
    monkeypatch.setenv("O2V_BATCH", "8")
    _bytes(_soup())
    assert engine.WAVE_STATS["batched"] == 0


def _spy_batches(monkeypatch):
    """Record each batched launch's (z_lo, z_hi) slabs, in pass order."""
    calls, inner = [], engine.fused_pass_batch

    def spy(table, passes, **kw):
        calls.append([tuple(p[3:5]) for p in passes])
        return inner(table, passes, **kw)

    monkeypatch.setattr(engine, "fused_pass_batch", spy)
    return calls


def test_passes_of_different_slabs_batch_together(monkeypatch):
    # a 2^13 budget: three slabs of several passes each
    soup = _soup(colored=True)
    kw = dict(strategy=BLEND_STRATEGY, max_pass_budget=1 << 13)
    want = _bytes(soup, **kw)
    _batched(monkeypatch)
    calls = _spy_batches(monkeypatch)
    assert _bytes(soup, **kw) == want
    assert any(len(set(slabs)) > 1 for slabs in calls), calls
    assert sum(len(c) for c in calls) == engine.WAVE_STATS["batched"]
    assert {len(c) for c in calls} <= {2, 4, 8}


@pytest.mark.parametrize("cap", ["8", "2"])
def test_supersampled_max_ties_survive_batching(monkeypatch, cap):
    soup = _soup(colored=True)
    kw = dict(strategy=MAX_STRATEGY, supersampling=2)
    want = _bytes(soup, **kw)
    _batched(monkeypatch, cap)
    calls = _spy_batches(monkeypatch)
    assert _bytes(soup, **kw) == want
    assert engine.WAVE_STATS["batched"] >= 2 and calls
    assert max(len(c) for c in calls) == int(cap)


def test_wave_cap_one_slab_a_wave(monkeypatch, capsys):
    soup = _soup()
    kw = dict(max_pass_budget=1 << 13)
    want = _bytes(soup, **kw)
    monkeypatch.setenv("O2V_TIMING", "1")
    _bytes(soup, **kw)
    waves = capsys.readouterr().out.count("[o2v-timing]   wave:")
    monkeypatch.setenv("O2V_WAVE_CAP", "1")
    assert _bytes(soup, **kw) == want
    capped = capsys.readouterr().out.count("[o2v-timing]   wave:")
    assert waves == 1 and capped > 1


@pytest.mark.parametrize("colored", [False, True])
def test_host_plan(monkeypatch, colored):
    # the host planner's order is the device planner's at group 1; the
    # default group of 8 buckets by a group's widest triangle, which moves
    # the pairs of exact MAX ties between the colored copies in the stream,
    # so the colored soup is held against group 1
    soup = _soup(colored)
    if colored:
        monkeypatch.setenv("O2V_GROUP", "1")
    want = _bytes(soup)
    monkeypatch.setenv("O2V_HOST_PLAN", "1")

    def refuse(*args, **kw):
        raise AssertionError("O2V_HOST_PLAN=1 called the device planner")

    monkeypatch.setattr(engine, "plan_mesh_device", refuse)
    assert _bytes(soup) == want


def _spy_groups(monkeypatch):
    groups, inner = [], engine.plan_mesh_device

    def spy(*args, group, **kw):
        groups.append(group)
        return inner(*args, group=group, **kw)

    monkeypatch.setattr(engine, "plan_mesh_device", spy)
    return groups


def test_group(monkeypatch):
    soup = _soup()
    groups = _spy_groups(monkeypatch)
    want = _bytes(soup)
    monkeypatch.setenv("O2V_GROUP", "1")
    assert _bytes(soup) == want
    assert groups == [engine.PLAN_GROUP, 1]


def test_group_reaches_the_windows(monkeypatch):
    soup = _soup()

    def sharded():
        xyz, argb = mesh.voxelize_sharded(soup, resolution=64, bounds=BOUNDS,
                                          devices=["cpu"] * 2, pair_tile=1 << 14)
        order = np.lexsort(xyz.T[::-1])
        return xyz[order].tobytes() + argb[order].tobytes()

    want = sharded()
    monkeypatch.setenv("O2V_GROUP", "1")
    groups = _spy_groups(monkeypatch)
    assert sharded() == want
    assert groups == [1, 1]


def test_max_pass_budget_is_read_at_import():
    # a fresh interpreter imports the engine under O2V_MAX_PASS_BUDGET=2^13,
    # which halves the soup's default budget: the colored soup gives the
    # bytes of max_pass_budget=2^13 in this process, the white one those of
    # the default budget (a smaller slot budget moves the slab edges and so the
    # colored copies' exact MAX ties in the stream; white has no ties)
    code = (
        "import hashlib, sys\n"
        f"sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'tests')!r}]\n"
        "from test_torch_stream_knobs import _bytes, _soup\n"
        "from obj2voxel_tpu_torch import engine\n"
        "digests = [hashlib.sha256(_bytes(_soup(c))).hexdigest()"
        " for c in (True, False)]\n"
        "print(engine.MAX_PASS_BUDGET, engine.WAVE_STATS['passes'], *digests)\n"
    )
    env = {**os.environ, "O2V_MAX_PASS_BUDGET": str(1 << 13)}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    budget, passes, colored, white = out.stdout.split()
    assert engine.MAX_PASS_BUDGET == 1 << 21 and int(budget) == 1 << 13
    want = _bytes(_soup(colored=True), max_pass_budget=1 << 13)
    assert colored == hashlib.sha256(want).hexdigest()
    small_passes = engine.WAVE_STATS["passes"]
    assert white == hashlib.sha256(_bytes(_soup())).hexdigest()
    assert int(passes) == small_passes > engine.WAVE_STATS["passes"]


def test_timing_lines(monkeypatch, capsys):
    soup = _soup()
    _batched(monkeypatch)
    want = _bytes(soup)
    assert "[o2v-timing]" not in capsys.readouterr().out
    monkeypatch.setenv("O2V_TIMING", "1")
    assert _bytes(soup) == want
    lines = capsys.readouterr().out.splitlines()
    stats = engine.WAVE_STATS
    assert lines[0].startswith("[o2v-timing] prepare ")
    assert lines[1].startswith("[o2v-timing] table+upload ")
    lines = lines[2:]
    assert lines[0].startswith("[o2v-timing]   hint ")
    assert lines[1].startswith("[o2v-timing] plan+gather ")
    assert " rows=6000 segments=" in lines[1]
    assert lines[2].startswith(
        f"[o2v-timing]   wave: 1 slabs {stats['passes']} passes "
        f"({stats['dispatches']} dispatches, {stats['batched']} batched) ")
    assert " (dispatch " in lines[2] and "counts=[" in lines[2]
    assert lines[3].startswith("[o2v-timing]   1 merges ")
    assert lines[4].startswith("[o2v-timing]   1 pulls ")
    assert len(lines) == 5
