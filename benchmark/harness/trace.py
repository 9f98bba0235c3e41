"""The traced run: a few steady conversions under `torch.profiler`, the
port's own counters read after each, and the reduction of the trace that
the per-layer readers (benchmark/metrics/) and the result's `breakdown`
take their numbers from.

Device busy time is the union of the device's operation intervals (the
arithmetic of scripts/profile_port.py `busy_ms`).  An idle gap is an
interval of the traced window that no device operation covers; it is
labelled with what was open at its middle: the benchmark's own span
(`bench.convert` around each conversion, and an adapter's own, such as
`bench.fold`, around its work between its calls into the port) and
the outermost host operation in the profiler's names, or "python" where
none ran.  The port's host seconds by stage come from its O2V_TIMING lines
in conversions that are not profiled.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import io
import os
import time
import warnings

import torch

from .window import Window

#: Published peaks of the cards the benchmark knows, by a part of the name
#: that torch.cuda.get_device_name() gives: NVIDIA's H100 SXM data sheet
#: (HBM3 bytes/s, float32 FLOP/s outside the tensor cores), at 700 W.
PEAKS = {"H100": {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}}


def peaks_of(kind: str):
    for part, peak in PEAKS.items():
        if part in kind:
            return peak
    return None


def union_seconds(intervals) -> float:
    """Total length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps_of(intervals, lo, hi):
    """The parts of [lo, hi] that no interval covers."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]


def top_level(events):
    """The (start, end, name) events that no earlier-starting one contains,
    sorted by start: on one thread they do not overlap."""
    out, end = [], None
    for s, e, name in sorted(events, key=lambda x: (x[0], -x[1])):
        if end is None or s >= end:
            out.append((s, e, name))
            end = e
    return out


@dataclasses.dataclass
class Trace:
    """What a traced run gives the per-layer readers."""

    conversions: list  # the profiled conversions (.work, .wall_s, .counters)
    staged: list  # the conversions under O2V_TIMING=1; .counters["stages"]
    kernels: list  # (name, start_us, end_us) of each device operation
    busy_s: float  # union of the device operations in the window
    window_s: float  # the traced window's length
    idle_gaps: list  # (label, seconds), the most first
    peaks: dict | None  # the card's published peaks, None if unknown

    @property
    def n(self) -> int:
        return len(self.conversions)

    def kernel_seconds(self, part: str) -> float:
        """Device seconds of the operations whose name contains `part`."""
        return sum(e - s for name, s, e in self.kernels if part in name) / 1e6

    def device_ops(self, top=10):
        by_name = {}
        for name, s, e in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        return sorted(by_name.items(), key=lambda x: -x[1])[:top]


class StageSink(io.TextIOBase):
    """Takes the port's standard output while O2V_TIMING=1 and turns each
    `[o2v-timing]` line into a (stage, start, end) interval on the host
    clock: the line ends a stage whose seconds `engine.TIMING_S` (read by
    `stage_seconds`) has just grown by.  The timing mode's own "hint"
    line, which the port prints inside its plan stage before planning,
    becomes the instant ("hint", t, t)."""

    def __init__(self, stage_seconds):
        self.stage_seconds = stage_seconds
        self.last = {}
        self.stages = []

    def reset(self):
        self.last = {}
        self.stages = []

    def write(self, text):
        if "[o2v-timing]" in text:
            now = time.perf_counter()
            if " hint " in text:
                self.stages.append(("hint", now, now))
            seen = self.stage_seconds()
            for stage, total in seen.items():
                grown = total - self.last.get(stage, 0.0)
                if grown > 0:
                    self.stages.append((stage, now - grown, now))
            self.last = dict(seen)
        return len(text)


def label_gaps(gaps, spans, ops):
    """Seconds of idle time by label, the most first.  A gap's label is what
    was open at its middle: the innermost benchmark span and the outermost
    host operation ("python" where none ran)."""
    op_starts = [s for s, _, _ in ops]
    by_label = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        inner = [(e - s, name) for s, e, name in spans if s <= mid <= e]
        span = min(inner)[1] if inner else "outside bench spans"
        i = bisect.bisect_right(op_starts, mid) - 1
        op = ops[i][2] if i >= 0 and ops[i][1] >= mid else "python"
        label = f"{span} > {op}"
        by_label[label] = by_label.get(label, 0.0) + (g1 - g0) / 1e6
    return sorted(by_label.items(), key=lambda x: -x[1])


def _annotation(event) -> bool:
    """A profiler range of the benchmark's or the profiler's own, which
    the trace also shows on the device's timeline: not a device
    operation."""
    return (getattr(event, "is_user_annotation", False)
            or event.name.startswith(("bench.", "ProfilerStep")))


def run(entry, plan, n: int, device) -> tuple[Window, Trace]:
    """One unrecorded conversion under the profiler and `n` recorded ones;
    then `n` conversions, not profiled, under O2V_TIMING=1, whose stage
    lines go to a StageSink.  The port's timing mode computes a hint
    inside each stream (38 ms of host time a conversion of the 10M-triangle
    sphere on an H100's host), so the profiled conversions run without
    it."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    device = torch.device(device)
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    conversions, staged = [], []

    def timed(index):
        entry.reset_counters()
        t0 = time.perf_counter()
        with record_function("bench.convert"):
            c = entry.convert(plan.units(index))
        c.wall_s = time.perf_counter() - t0
        c.counters = entry.counters()
        return c

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the schedule's one cycle
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=n, repeat=1)) as prof:
            entry.convert(set())
            prof.step()
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            t_start = time.perf_counter()
            for i in range(n):
                conversions.append(timed(i))
                prof.step()
    sink = StageSink(lambda: entry.counters()["timing_s"])
    os.environ["O2V_TIMING"] = "1"
    try:
        for i in range(n):
            sink.reset()
            with contextlib.redirect_stdout(sink):
                c = timed(n + i)
            c.counters["stages"] = list(sink.stages)
            staged.append(c)
    finally:
        del os.environ["O2V_TIMING"]
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    window = Window(conversions + staged, t_start, time.perf_counter(), peak)

    kernels, spans, ops = [], [], []
    for e in prof.events():
        item = (e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not _annotation(e):
                kernels.append((e.name, *item))
        elif e.name.startswith("bench."):
            spans.append((*item, e.name))
        elif not _annotation(e):
            ops.append((*item, e.name))
    w0 = min(s for s, _, _ in spans)
    w1 = max(e for _, e, _ in spans)
    inside = [(max(s, w0), min(e, w1)) for _, s, e in kernels if e > w0 and s < w1]
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    return window, Trace(
        conversions=conversions,
        staged=staged,
        kernels=[k for k in kernels if k[2] > w0 and k[1] < w1],
        busy_s=union_seconds(inside) / 1e6,
        window_s=(w1 - w0) / 1e6,
        idle_gaps=label_gaps(gaps_of(inside, w0, w1), spans, top_level(ops)),
        peaks=peaks_of(kind),
    )
