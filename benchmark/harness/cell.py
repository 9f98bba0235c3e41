"""One run of one cell: set-up, the window (or the traced conversions),
the reference and the comparison, and the result's last line.

Set-up is the inputs drawn from the seed, the port's kernel library
(built in the checkout on its first run, loaded after), the adapter's own
set-up (a stream's table) and one warm conversion: every shape the window
uses.  After the window the port's state is freed before the reference
runs, so the reference sets no peak of the port's.  The whole run holds
the traffic mix's port knobs (spec.port_env).
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

from . import checks, inputs, spec, trace, window

#: Top-level module names that no run may hold: JAX, its libraries, and
#: the JAX package that the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "obj2voxel_tpu")


def forbidden_modules() -> list[str]:
    """Modules whose top-level name, the part before the first dot, is one
    of FORBIDDEN, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def _log(text):
    print(text, file=sys.stderr, flush=True)


def run_cell(root, workload: str, seed: int, seconds: float, trace_on: bool,
             device="cuda", t_process: float | None = None) -> dict:
    """Run the cell once and return the result's object (the last line)."""
    t_process = time.perf_counter() if t_process is None else t_process
    cell = spec.resolve(root, workload)
    with spec.port_env(cell):
        return _run(cell, seed, seconds, trace_on, torch.device(device), t_process)


def _run(cell, seed, seconds, trace_on, device, t_process) -> dict:
    cuda = device.type == "cuda"
    split = {"import": time.perf_counter() - t_process}

    t = time.perf_counter()
    made = inputs.make(cell, seed, device)
    split["inputs"] = time.perf_counter() - t
    entry = cell.entry(cell.config, made, device)
    t = time.perf_counter()
    entry.load_kernels()
    split["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    entry.setup()
    split["table"] = time.perf_counter() - t
    t = time.perf_counter()
    entry.convert(set())
    split["warm"] = time.perf_counter() - t
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    setup_s = time.perf_counter() - t_process
    _log("setup split (s): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
         + f"; total {setup_s:.3f}")

    plan = window.KeepPlan(cell.traffic.get("keep", {}), entry.n_units, seed)
    if trace_on:
        win, tr = trace.run(entry, plan, int(cell.traffic["traced_conversions"]), device)
    else:
        win, tr = window.run(entry, plan, seconds, device), None
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    peak_bytes = None if not cuda else max(setup_peak, win.peak_bytes)
    entry.free()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    reference = entry.reference(torch.float32, device)
    ref_s = time.perf_counter() - t
    t = time.perf_counter()
    judged, failed, tied = checks.judge(win.conversions, entry.unit_arrays, reference,
                                        int(cell.config["guarantees"]["color_lsb"]))
    walls = [c.wall_s for c in win.conversions]
    _log(f"reference {ref_s:.3f} s, comparison {time.perf_counter() - t:.3f} s "
         f"({tied} tied voxels of the whole conversion left out of color_lsb); "
         f"{len(walls)} conversions in {win.seconds:.3f} s; conversion s: first "
         + " ".join(f"{w:.4f}" for w in walls[:3])
         + f", min {min(walls):.4f}, median {window.percentile(walls, 50):.4f}, "
         f"max {max(walls):.4f}")
    if len(walls) <= 64:
        _log("conversion s: " + " ".join(f"{w:.4f}" for w in walls))

    # the cell's end-to-end metrics from the window, or its per-layer ones
    # from the trace; a metric with nothing to read is left out
    metrics = {}
    for name, (entry_m, source) in (cell.per_layer if trace_on else cell.end_to_end).items():
        value = source.read(tr) if trace_on else window.end_to_end(source, win, setup_s)
        if value is not None:
            metrics[name] = {"value": value, "unit": entry_m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": peak_bytes}
    if cuda:
        dev["power"] = power_limit()
    result = {"correct": checks.passed(judged), "attempted": len(win.conversions),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace_on:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops()],
                               "idle_gaps": [list(x) for x in tr.idle_gaps[:10]]}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"benchmark: the run holds {found} after its window")
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in judged.items()}
    for k, (v, lim) in judged.items():
        _log(f"check {k} {v} limit {lim}")
    return result
