"""A tiny instance of each cell, run through the harness on the CPU: the
port agrees with the plain reference; the control and a timed path broken
underneath come out as not correct; a further configuration, traffic mix
and metric are added from new files only."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.harness import cell, spec

from .conftest import BATCH, MESH


@pytest.mark.parametrize("workload", [MESH, BATCH])
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_agrees_with_the_reference(tiny_root, workload, traced):
    r = cell.run_cell(tiny_root, workload, 2**31 + 123, 0.5, traced, "cpu")
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())
    names = spec.resolve(tiny_root, workload)
    expected = names.per_layer if traced else names.end_to_end
    assert set(r["metrics"]) <= set(expected)
    if not traced:
        assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    else:
        assert r["device"]["window_s"] > 0 and "breakdown" in r


@pytest.mark.parametrize("workload", [MESH, BATCH])
def test_control_is_not_correct(tiny_root, workload):
    got = control.control_readings(tiny_root, workload, 11, "cpu")
    assert not got["passed"]
    assert got["checks"]["voxels_differ"]["value"] > 0


def _break_stream(monkeypatch, fault):
    from obj2voxel_tpu_torch import engine

    real = engine.stream_slabs

    def broken(*args, **kwargs):
        for i, (xyz, argb, count) in enumerate(real(*args, **kwargs)):
            if fault == "empty":
                continue
            if i == 0 and fault == "color":
                argb = argb.clone()
                argb[0] = argb[0] ^ 0x80
            if i == 0 and fault == "drop":
                count -= 1
                xyz, argb = xyz[1:], argb[1:]
            yield xyz, argb, count

    monkeypatch.setattr(engine, "stream_slabs", broken)


def _break_batch(monkeypatch, fault):
    from obj2voxel_tpu_torch import engine

    real = engine.voxelize_batch

    def broken(soups, *args, **kwargs):
        if fault == "half":
            out = real(soups[: len(soups) // 2], *args, **kwargs)
            return out + [(np.zeros((0, 3), np.int32), np.zeros(0, np.uint32))] * (
                len(soups) - len(out))
        out = real(soups, *args, **kwargs)
        xyz, argb = out[0]
        argb = argb.copy()
        argb[0] ^= 1 << 8
        return [(xyz, argb)] + out[1:]

    monkeypatch.setattr(engine, "voxelize_batch", broken)


@pytest.mark.parametrize("fault", ["empty", "color", "drop"])
def test_broken_stream_is_not_correct(tiny_root, monkeypatch, fault):
    _break_stream(monkeypatch, fault)
    r = cell.run_cell(tiny_root, MESH, 5, 0.2, False, "cpu")
    assert not r["correct"]


@pytest.mark.parametrize("fault", ["half", "color"])
def test_broken_batch_is_not_correct(tiny_root, monkeypatch, fault):
    _break_batch(monkeypatch, fault)
    r = cell.run_cell(tiny_root, BATCH, 6, 0.2, False, "cpu")
    assert not r["correct"]


def test_later_conversion_broken_is_caught(tiny_root, monkeypatch):
    """Only the window's second conversion is wrong: its digest differs
    from the conversion kept whole."""
    from obj2voxel_tpu_torch import engine

    real = engine.stream_slabs
    calls = []

    def broken(*args, **kwargs):
        calls.append(1)
        for i, (xyz, argb, count) in enumerate(real(*args, **kwargs)):
            if len(calls) == 3 and i == 0:  # set-up's warm call, then the window's
                argb = argb.clone()
                argb[0] = argb[0] ^ 0x80
            yield xyz, argb, count

    monkeypatch.setattr(engine, "stream_slabs", broken)
    r = cell.run_cell(tiny_root, MESH, 7, 0.5, False, "cpu")
    assert r["attempted"] >= 2
    assert not r["correct"] and r["checks"]["conversions_off"]["value"] >= 1


def _digest(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_config_traffic_and_metric_from_new_files_only(tiny_root):
    before = _digest(tiny_root)
    data = tiny_root / "benchmark"
    (data / "configs" / "mesh32_max.json").write_text(json.dumps({
        "name": "mesh32_max", "resolution": 32, "strategy": "max",
        "guarantees": {"color_lsb": 0}, "reduced": []}))
    (data / "traffic" / "sphere2k_device.json").write_text(json.dumps({
        "entry": "stream_device", "traced_conversions": 1, "keep": {"units": 0},
        "inputs": {"kind": "sphere_in_grid", "triangles": 2000}}))
    (data / "end_to_end" / "mvox_per_s.json").write_text(json.dumps(
        {"kind": "rate", "work": "voxels", "scale": 1e-6}))
    (data / "metrics" / "voxels.small.py").write_text(
        "def read(trace):\n"
        "    return sum(c.work['voxels'] for c in trace.conversions) / trace.n\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    new = "mesh32_max.sphere2k_device"
    bench["configs"].append({"name": "mesh32_max", "source": "a test", "why": "a test",
                             "file": "benchmark/configs/mesh32_max.json", "reduced": []})
    bench["workloads"].append({"name": new, "config": "mesh32_max",
                               "traffic": "sphere2k_device", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "mvox_per_s", "unit": "Mvox/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": [new]})
    bench["per_layer"].append({"name": "voxels.small", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "merges",
                               "moves": "mvox_per_s", "workloads": [new]})
    # only BENCHMARK.json changes; every file of the benchmark stays
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(tiny_root)
    changed = [p for p in before if before[p] != after[p]]
    assert changed == [tiny_root / "BENCHMARK.json"]

    r = cell.run_cell(tiny_root, new, 3, 0.2, False, "cpu")
    assert r["correct"] and {"mvox_per_s", "setup_s"} <= set(r["metrics"])
    assert "mtri_per_s" not in r["metrics"]
    r = cell.run_cell(tiny_root, new, 3, 0.2, True, "cpu")
    assert r["correct"] and r["metrics"]["voxels.small"]["value"] > 0
    # the cells that were there before still resolve, unchanged
    assert "voxels.small" not in spec.resolve(tiny_root, MESH).per_layer


@pytest.mark.card
@pytest.mark.parametrize("workload", [MESH, BATCH])
def test_cell_on_the_card(card, workload):
    """One short run of each cell at its real size on the card."""
    from .conftest import ROOT

    r = cell.run_cell(ROOT, workload, 2**31 + 5, 2.0, False, card)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert torch.cuda.max_memory_allocated() > 0


#: A pull-mode stream: the port's voxels pulled to the host slab by slab.
PULL_ENTRY = '''
import numpy as np
import torch

from benchmark.harness.adapter import Adapter, Conversion, unit_keys
from benchmark.reference.voxelize import voxelize


class Entry(Adapter):
    n_units = 1

    def setup(self):
        from obj2voxel_tpu_torch.constants import TRI_UNTEXTURED
        from obj2voxel_tpu_torch.engine import host_table

        verts, rgb = self.inputs.meshes[0]
        n = verts.shape[0]
        table, self.aabb = host_table(
            verts, np.zeros((n, 3, 2), np.float32), np.full(n, TRI_UNTEXTURED, np.int32),
            rgb, np.full(n, -1, np.int32), stride=self.resolution, z_extent=self.resolution)
        self.table = torch.from_numpy(table).to(self.device)

    def convert(self, keep):
        from obj2voxel_tpu_torch import engine

        r = self.resolution
        parts = list(engine.stream_slabs(self.table, None, aabb_host=self.aabb, stride=r,
                                         z_extent=r, is_blend=self.blend))
        xyz = np.concatenate([x for x, _ in parts])
        argb = np.concatenate([a for _, a in parts])
        return Conversion({"triangles": self.inputs.triangles, "meshes": 1,
                           "voxels": xyz.shape[0]}, {0: (xyz, argb)})

    def unit_arrays(self, unit):
        return unit_keys(unit[0], self.resolution), np.asarray(unit[1], np.uint32)

    def reference(self, dtype, device):
        verts, rgb = self.inputs.meshes[0]
        return {0: voxelize(verts, rgb, stride=self.resolution, z_extent=self.resolution,
                            blend=self.blend, device=device, dtype=dtype)}
'''

#: An octahedron in the grid, its corners moved and its faces colored by
#: the seed.
OCTAHEDRON = '''
import numpy as np

from benchmark.harness.inputs import Inputs

FACES = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
         (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]


def make(params, resolution, rng, seed, device):
    c, r = resolution / 2.0, params["radius"] * resolution
    corners = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                        [0, 0, -1]], np.float64) * r + c + rng.uniform(-1, 1, (6, 3))
    verts = corners[np.array(FACES)].astype(np.float32)
    rgb = rng.integers(0, 256, (len(FACES), 3)).astype(np.float32) / np.float32(255)
    return Inputs([(verts, rgb)], "grid")
'''


def test_new_entry_generator_and_knob_from_new_files_only(tiny_root):
    """A pull-mode stream adapter, an octahedron generator and a mix that
    sets one of the port's knobs, each a new file; no file that was there
    changes but BENCHMARK.json."""
    before = _digest(tiny_root)
    data = tiny_root / "benchmark"
    (data / "entries" / "stream_pull.py").write_text(PULL_ENTRY)
    (data / "inputs" / "octahedron_in_grid.py").write_text(OCTAHEDRON)
    (data / "traffic" / "octahedron_pull_hostplan.json").write_text(json.dumps({
        "entry": "stream_pull", "traced_conversions": 1, "keep": {"units": 1},
        "port_env": {"O2V_HOST_PLAN": "1"},
        "inputs": {"kind": "octahedron_in_grid", "radius": 0.4}}))
    (data / "metrics" / "host_plan.pull.py").write_text(
        "def read(trace):\n"
        "    return min(c.counters['wave']['host_plan'] for c in trace.conversions)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    new = "mesh1024_blend.octahedron_pull_hostplan"
    bench["workloads"].append({"name": new, "config": "mesh1024_blend",
                               "traffic": "octahedron_pull_hostplan", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("mtri_per_s", "convert_p95_ms"):
            m["workloads"].append(new)
    bench["per_layer"].append({"name": "host_plan.pull", "unit": "count", "better": "lower",
                               "source": "program_counter", "layer": "plan",
                               "moves": "mtri_per_s", "workloads": [new]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(tiny_root)
    assert [p for p in before if before[p] != after[p]] == [tiny_root / "BENCHMARK.json"]

    cell_ = spec.resolve(tiny_root, new)
    assert cell_.port_env == {"O2V_HOST_PLAN": "1"}
    r = cell.run_cell(tiny_root, new, 2**33 + 1, 0.2, False, "cpu")
    assert r["correct"] and {"mtri_per_s", "convert_p95_ms", "setup_s"} <= set(r["metrics"])
    r = cell.run_cell(tiny_root, new, 2**33 + 2, 0.2, True, "cpu")
    assert r["correct"] and r["metrics"]["host_plan.pull"]["value"] == 1
    # the knob holds for the cell's run alone
    import os

    assert "O2V_HOST_PLAN" not in os.environ
    r = cell.run_cell(tiny_root, MESH, 2**33 + 3, 0.2, True, "cpu")
    assert r["correct"]


def test_port_env_takes_only_the_ports_knobs(tiny_root):
    path = tiny_root / "benchmark" / "traffic" / "sphere10m_device.json"
    data = json.loads(path.read_text())
    for bad in ({"O2V_TIMING": "1"}, {"HOME": "/"}, {"O2V_BATCH": 8}):
        data["port_env"] = bad
        path.write_text(json.dumps(data))
        with pytest.raises(ValueError):
            spec.resolve(tiny_root, MESH)
