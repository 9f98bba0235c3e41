"""BENCHMARK.json: every entry resolves to its files by name, and the
file keeps the benchmark's contract on names, keys and limits."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.harness import spec

from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_by_name(workload):
    cell = spec.resolve(ROOT, workload)
    assert cell.config["resolution"] > 0
    assert cell.traffic["entry"]
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for _, reader in cell.per_layer.values():
        assert callable(reader.read)


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert (ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check of 24 cells, 2 + 14 x 24 runs, fits in 12 hours
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert cells <= 24


def test_names_units_and_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in names
            names.add((group, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in CELLS:
        reported = {n for n, m in e2e.items() if w in m.get("workloads", [w])}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
