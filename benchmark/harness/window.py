"""The measured window and the end-to-end arithmetic.

A cell is a closed loop with one client: conversions run back to back
until the window's seconds have passed, and the conversion in flight then
completes.  Each is timed on the host clock from its call to the device
synchronize after its last output.  A rate is all the work of the window
over the time from its start to its last completion; a percentile is over
every conversion of the window.

End-to-end recipes (benchmark/end_to_end/<metric>.json), by "kind":
  rate        the sum of the conversions' work["work"] over the window's
              time, times "scale"
  percentile  the "q"-th percentile of the conversions' times, times
              "scale" (linear between the two nearest ranks)
  peak_memory the device's peak allocated bytes over the window, after a
              reset at its start, times "scale"
  setup       the seconds from the process's start to the window's start
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch


@dataclasses.dataclass
class Window:
    """What a window measured."""

    conversions: list  # adapter.Conversion, in order
    t_start: float  # host clock at the window's start
    t_end: float  # host clock at its last completion
    peak_bytes: int | None  # device peak over the window (None on the CPU)

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


def rate(window: Window, work: str) -> float:
    """All the work of the window's conversions over its time."""
    return sum(c.work[work] for c in window.conversions) / window.seconds


def percentile(values, q: float) -> float:
    """The q-th percentile of values, linear between the nearest ranks."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def end_to_end(recipe: dict, window: Window, setup_s: float):
    """One end-to-end metric's value, or None where it has nothing to read
    (peak memory on the CPU)."""
    kind = recipe["kind"]
    scale = float(recipe.get("scale", 1.0))
    if kind == "rate":
        return rate(window, recipe["work"]) * scale
    if kind == "percentile":
        return percentile([c.wall_s for c in window.conversions], float(recipe["q"])) * scale
    if kind == "peak_memory":
        return None if window.peak_bytes is None else window.peak_bytes * scale
    if kind == "setup":
        return setup_s * scale
    raise ValueError(f"benchmark: unknown end-to-end kind {kind!r}")


class KeepPlan:
    """Which outputs of which conversions are kept for the comparison: every
    unit of the window's first conversion, and of each later one a sample
    of `units` units drawn from the seed.  A stream keeps its one unit
    whole once, so its device memory is the same in every run."""

    def __init__(self, keep: dict, n_units: int, seed: int):
        self.rng = np.random.default_rng([seed, 1])
        self.per_conversion = min(int(keep.get("units", 0)), n_units)
        self.n_units = n_units

    def units(self, index: int):
        if index == 0:
            return "all"
        return set(self.rng.choice(self.n_units, self.per_conversion, replace=False).tolist())


def run(entry, plan: KeepPlan, seconds: float, device) -> Window:
    """Run conversions back to back for `seconds`, the last one to its
    end."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    conversions = []
    t_start = time.perf_counter()
    t_end = t_start
    while t_end - t_start < seconds or not conversions:
        t0 = time.perf_counter()
        c = entry.convert(plan.units(len(conversions)))
        t_end = time.perf_counter()
        c.wall_s = t_end - t0
        conversions.append(c)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    return Window(conversions, t_start, t_end, peak)
