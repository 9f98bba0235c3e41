"""A cell's files, found by the names in BENCHMARK.json.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own under the benchmark's directory, named after it:

    <config's "file">                    the configuration's sizes
    benchmark/traffic/<traffic>.json     the traffic mix's parameters
    benchmark/entries/<entry>.py         the adapter that the mix's "entry"
                                         names: the call into the port and
                                         the matching call into the reference
    benchmark/inputs/<kind>.py           the generator that the mix's
                                         "inputs" "kind" names
    benchmark/end_to_end/<metric>.json   an end-to-end metric's recipe
    benchmark/metrics/<metric>.py        a per-layer metric's reader

so a later change adds a cell, a mix, an adapter, a generator or a metric
as new files.  A mix may also set the port's knobs for its run
("port_env": {"O2V_...": "value"}); every other O2V_* variable is cleared.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

#: The benchmark's own directory, relative to the checkout's root.
BENCH_DIR = "benchmark"


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names loaded."""

    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    entry: type  # the adapter class `Entry` of benchmark/entries/<entry>.py
    generator: object  # the module benchmark/inputs/<kind>.py, with make()
    port_env: dict  # the port's O2V_* knobs that the mix sets
    end_to_end: dict  # metric name -> (entry of BENCHMARK.json, recipe)
    per_layer: dict  # metric name -> (entry of BENCHMARK.json, reader module)


def load_benchmark(root) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"benchmark: no file {path}")
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, kind: str, needs: str):
    """The module in the file `path`, which has to define `needs`."""
    if not path.is_file():
        raise FileNotFoundError(f"benchmark: no {kind} {path}")
    name = f"_bench_{kind}_{path.stem}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    if not callable(getattr(module, needs, None)):
        raise ValueError(f"benchmark: {path} has no {needs}")
    return module


def load_reader(path: Path):
    """A per-layer metric's reader: a module with `read(trace)` that returns
    the metric's value, or None where it finds nothing to read."""
    return load_module(path, "metric", "read")


def _port_env(traffic: dict) -> dict:
    env = traffic.get("port_env", {})
    for key, value in env.items():
        if not key.startswith("O2V_") or key == "O2V_TIMING" or not isinstance(value, str):
            raise ValueError(f"benchmark: port_env takes O2V_* knobs as strings, "
                             f"not O2V_TIMING (the traced run sets it): {key!r}")
    return dict(env)


@contextlib.contextmanager
def port_env(cell: Cell):
    """The cell's port knobs set in the environment, and every other O2V_*
    variable cleared, for the time of the block."""
    saved = {k: v for k, v in os.environ.items() if k.startswith("O2V_")}
    for key in saved:
        del os.environ[key]
    os.environ.update(cell.port_env)
    try:
        yield
    finally:
        for key in [k for k in os.environ if k.startswith("O2V_")]:
            del os.environ[key]
        os.environ.update(saved)


def resolve(root, workload: str, bench: dict | None = None) -> Cell:
    """The cell named `workload`, its configuration, traffic mix and the
    metrics that it reports, loaded from their files under `root`."""
    root = Path(root)
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"benchmark: no workload {workload!r}; one of {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    data = root / BENCH_DIR
    traffic = load_json(data / "traffic" / f"{w['traffic']}.json")
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=load_json(root / configs[w["config"]]["file"]),
        traffic=traffic,
        entry=load_module(data / "entries" / f"{traffic['entry']}.py", "entry", "Entry").Entry,
        generator=load_module(data / "inputs" / f"{traffic['inputs']['kind']}.py",
                              "inputs", "make"),
        port_env=_port_env(traffic),
        end_to_end={m["name"]: (m, load_json(data / "end_to_end" / f"{m['name']}.json"))
                    for m in bench["end_to_end"] if _applies(m, workload)},
        per_layer={m["name"]: (m, load_reader(data / "metrics" / f"{m['name']}.py"))
                   for m in bench["per_layer"] if _applies(m, workload)},
    )
