"""The end-to-end arithmetic on synthetic timings, and the trace's
interval arithmetic."""

from __future__ import annotations

import statistics

import pytest

from benchmark.harness import trace, window
from benchmark.harness.adapter import Conversion


def _window(walls, work):
    convs = []
    for w in walls:
        c = Conversion(work=dict(work), units={})
        c.wall_s = w
        convs.append(c)
    return window.Window(convs, 100.0, 100.0 + sum(walls), None)


def test_rate_is_all_the_work_over_all_the_time():
    walls = [0.05] * 99 + [2.0]  # one stall
    win = _window(walls, {"triangles": 1_000_000, "meshes": 1})
    got = window.end_to_end({"kind": "rate", "work": "triangles", "scale": 1e-6}, win, 0.0)
    assert got == pytest.approx(100 / sum(walls))
    # not the mean of per-conversion rates, which hides the stall
    assert got < statistics.mean(1 / w for w in walls)


@pytest.mark.parametrize("n, stall_rank_from_top", [(100, 1), (100, 5), (100, 6), (400, 1)])
def test_p95_is_over_every_conversion(n, stall_rank_from_top):
    walls = [0.050 + 0.0001 * i for i in range(n)]
    stalls = n - stall_rank_from_top
    walls = [2.0 if i >= stalls else w for i, w in enumerate(walls)]
    win = _window(walls, {"triangles": 1})
    got = window.end_to_end({"kind": "percentile", "q": 95, "scale": 1000.0}, win, 0.0)
    pos = (n - 1) * 0.95
    ordered = sorted(walls)
    want = ordered[int(pos)] + (ordered[int(pos) + 1] - ordered[int(pos)]) * (pos - int(pos))
    assert got == pytest.approx(1000 * want)
    # a stall among the top 5% moves the p95 once it reaches the rank it sits on
    assert (got > 1000.0) == (stall_rank_from_top * 100 > 5 * n)


def test_percentile_matches_numpy_linear():
    import numpy as np

    values = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.0]
    for q in (0, 50, 95, 100):
        assert window.percentile(values, q) == pytest.approx(np.percentile(values, q))


def test_setup_and_peak():
    win = _window([0.1], {"meshes": 1})
    assert window.end_to_end({"kind": "setup"}, win, 12.5) == 12.5
    assert window.end_to_end({"kind": "peak_memory", "scale": 2**-30}, win, 0.0) is None
    win.peak_bytes = 3 * 2**30
    assert window.end_to_end({"kind": "peak_memory", "scale": 2**-30}, win, 0.0) == 3.0


def test_union_and_gaps():
    spans = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert trace.union_seconds(spans) == 12 + 10 + 1
    assert trace.gaps_of(spans, 0, 50) == [(12, 20), (30, 40), (41, 50)]
    assert trace.gaps_of(spans, 3, 22) == [(12, 20)]


def test_gap_labels():
    spans = [(0, 100, "bench.convert"), (60, 80, "bench.fold")]
    ops = trace.top_level([(10, 30, "aten::sort"), (12, 20, "aten::copy_")])
    got = dict(trace.label_gaps([(14, 16), (50, 54), (70, 72), (101, 102)], spans, ops))
    assert got == {"bench.convert > aten::sort": 2e-6, "bench.convert > python": 4e-6,
                   "bench.fold > python": 2e-6, "outside bench spans > python": 1e-6}


def test_stage_sink_and_plan_reader():
    import importlib.util

    from .conftest import ROOT

    totals = {}
    sink = trace.StageSink(lambda: totals)
    sink.write("[o2v-timing]   hint 3ms (est 1e6 -> 2)\n")
    totals["plan"] = 0.5
    sink.write("[o2v-timing] plan+gather 500ms\n")
    (h, h0, h1), (name, s, e) = sink.stages
    assert h == "hint" and h0 == h1 and name == "plan" and e - s == 0.5 and s <= h0 <= e
    path = ROOT / "benchmark" / "metrics" / "plan_ms.mesh.py"
    spec = importlib.util.spec_from_file_location("plan_reader", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    c = Conversion(work={}, units={})
    c.counters = {"stages": sink.stages}
    tr = trace.Trace([], [c], [], 0.0, 0.0, [], None)
    assert reader.read(tr) == pytest.approx(1e3 * (e - h1))


def test_keep_plan_is_drawn_from_the_seed():
    a = window.KeepPlan({"units": 5}, 100, 2**31 + 9)
    b = window.KeepPlan({"units": 5}, 100, 2**31 + 9)
    assert a.units(0) == "all"
    got = [a.units(i) for i in range(1, 6)]
    assert got == [b.units(i) for i in range(1, 6)]
    assert all(len(s) == 5 for s in got)
    assert window.KeepPlan({}, 1, 3).units(4) == set()
