"""Fixtures of the benchmark's tests: a tiny copy of the benchmark's data
in a temporary checkout, and the decision, made inside a fixture, whether
a card is there."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

MESH = "mesh1024_blend.sphere10m_device"
BATCH = "dataset64_max.spheres1000"

#: Each cell's data cut to a size a CPU test run holds: (file, key path,
#: value).
TINY = [
    ("benchmark/traffic/sphere10m_device.json", ("inputs", "triangles"), 3000),
    ("benchmark/traffic/sphere10m_device.json", ("traced_conversions",), 2),
    ("benchmark/configs/mesh1024_blend.json", ("resolution",), 48),
    ("benchmark/traffic/spheres1000.json", ("inputs", "meshes"), 12),
    ("benchmark/traffic/spheres1000.json", ("keep", "units"), 3),
    ("benchmark/configs/dataset64_max.json", ("resolution",), 16),
]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


def copy_checkout(dest: Path, tiny: bool = True) -> Path:
    """BENCHMARK.json and the benchmark's data files under `dest`, cut to
    TINY sizes where `tiny`."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for rel, path, value in TINY if tiny else []:
        data = json.loads((dest / rel).read_text())
        node = data
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = value
        (dest / rel).write_text(json.dumps(data))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return copy_checkout(tmp_path)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
