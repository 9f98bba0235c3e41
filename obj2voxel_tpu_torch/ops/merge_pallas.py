"""K6: stable merge of key-sorted runs (csrc/merge_runs.cu).

The counterpart of obj2voxel_tpu/ops/merge_pallas.py `merge_runs_pallas`.
The input is the concatenation of S <= 32 runs, each sorted by key: keys
(P,) int32 and a 4-tuple of (P,) float32 channels, with the S + 1 run
boundaries as host ints.  The output is the input in the order of
`torch.sort(keys, stable=True)`: equal keys keep run order, then position
order.  ceil(log2 S) levels each merge neighbouring groups of runs.

The runs lie densely, one after the other.  The TPU version's block-aligned
layout (`build_aoff`, INVALID alignment padding, `_WIN_PAD` slack rows and
the window DMA) exists only for its VMEM windows and is not carried over.

`merge_runs` takes the plain version for CPU tensors and launches the CUDA
kernel, once per level, for CUDA tensors; `merge_runs_ref` is the plain
version, built from `torch.searchsorted` without a sort.  The levels before
the last pass (key, source row) composites through int64 scratch; each level
launch covers its group pairs in tiles of MERGE_TILE output rows
(`plan_levels`).  The outputs are the five rows of one (5, P) int32 buffer,
the channels viewed as float32: one allocation, not five.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

#: Most runs one merge takes (csrc/merge_runs.cu O2V_MAX_RUNS).
MAX_RUNS = 32

#: Output rows per block of a level launch (csrc/merge_runs.cu MERGE_TILE:
#: 128 threads x 15 rows).
MERGE_TILE = 128 * 15


def plan_runs(counts):
    """Dense layout of runs of `counts` rows: (offsets, levels) with
    offsets the S + 1 run boundaries and levels = ceil(log2 S)."""
    offsets = [0]
    for c in counts:
        offsets.append(offsets[-1] + int(c))
    return offsets, _levels(len(counts))


def _levels(n_runs):
    """ceil(log2 n_runs): the merge levels of n_runs runs."""
    return max(n_runs - 1, 0).bit_length()


def _groups(offsets, level):
    """(start, middle, end) of every pair of run groups merged at `level`."""
    s = len(offsets) - 1
    span = 2 << level
    return [(offsets[g], offsets[min(g + span // 2, s)], offsets[min(g + span, s)])
            for g in range(0, s, span)]


def plan_levels(offsets):
    """The launch plan of every merge level: for each pair of run groups the
    level merges, (left start, right start, end, first tile), then the
    level's tile count, flat as the kernel takes it (csrc/merge_runs.cu
    `o2v_merge_runs`).  A pair without rows has no tile."""
    plans = []
    for level in range(_levels(len(offsets) - 1)):
        flat, tiles = [], 0
        for a, m, e in _groups(offsets, level):
            flat += [a, m, e, tiles]
            tiles += -(-(e - a) // MERGE_TILE)
        plans.append(flat + [tiles])
    return plans


def merge_runs_ref(keys, chans, offsets):
    """Plain version, level by level: a row of a left group moves by the
    number of right keys below its key, a row of a right group by the number
    of left keys at or below it (ties go left)."""
    offsets = [int(o) for o in offsets]
    chans = tuple(chans)
    for level in range(_levels(len(offsets) - 1)):
        dst = torch.arange(keys.numel(), dtype=torch.int64, device=keys.device)
        for a, m, e in _groups(offsets, level):
            if a == m or m == e:
                continue
            left, right = keys[a:m], keys[m:e]
            dst[a:m] += torch.searchsorted(right, left, side="left")
            dst[m:e] += a - m + torch.searchsorted(left, right, side="right")
        out = torch.empty_like(keys)
        out[dst] = keys
        outs = []
        for c in chans:
            o = torch.empty_like(c)
            o[dst] = c
            outs.append(o)
        keys, chans = out, tuple(outs)
    return keys, chans


def _check(keys, chans, offsets):
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError("merge_runs: keys must be a 1-D int32 tensor")
    if len(chans) != 4:
        raise ValueError("merge_runs: expected 4 value channels")
    for c in chans:
        if c.dtype != torch.float32 or c.shape != keys.shape:
            raise ValueError("merge_runs: channels must be float32 like keys")
    if not 2 <= len(offsets) <= MAX_RUNS + 1:
        raise ValueError(f"merge_runs: between 1 and {MAX_RUNS} runs, got "
                         f"{len(offsets) - 1}")
    if offsets[0] != 0 or offsets[-1] != keys.numel() or any(
            b < a for a, b in zip(offsets, offsets[1:])):
        raise ValueError("merge_runs: offsets must rise from 0 to the length")
    if keys.numel() >= 1 << 31:
        raise ValueError("merge_runs: stream longer than int32 indexing")


def merge_runs(keys, chans, offsets):
    """Stable merge of the key-sorted runs [offsets[i], offsets[i+1]).

    Returns (keys', chans' 4-tuple): the stable sort of the input by key.
    One run is returned as it is."""
    offsets = [int(o) for o in offsets]
    chans = tuple(chans)
    _check(keys, chans, offsets)
    if keys.device.type == "cpu":
        return merge_runs_ref(keys, chans, offsets)
    dev = _cuda.require_cuda("merge_runs", keys, *chans)
    plans = plan_levels(offsets)
    n = keys.numel()
    if not plans or n == 0:
        return keys, chans
    out = torch.empty((5, n), dtype=torch.int32, device=dev)
    # (key, source row) composites between levels, in two buffers at most
    scratch = torch.empty(min(len(plans) - 1, 2) * n, dtype=torch.int64, device=dev)
    flat = [x for plan in plans for x in (len(plan) // 4, *plan)]
    p = out.data_ptr()
    err = _cuda.lib().o2v_merge_runs(
        keys.data_ptr(), *(c.data_ptr() for c in chans),
        *(p + 4 * n * i for i in range(5)), scratch.data_ptr(),
        ctypes.cast((ctypes.c_int * len(flat))(*flat), ctypes.c_void_p),
        len(plans), n, _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "merge_runs")
    _cuda.count_launch("merge_runs", len(plans))  # one launch a level
    return out[0], tuple(out[i].view(torch.float32) for i in range(1, 5))
