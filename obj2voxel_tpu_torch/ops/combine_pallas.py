"""K2 `segment_combine` and the fused `combine_pack`, two instances of the
single-pass reduce-by-key csrc/reduce_by_key.cu (ops/reduce_by_key.py).

`segment_combine` is the counterpart of obj2voxel_tpu/ops/combine_pallas.py
`segment_combine_pallas`.  Over a key-sorted premultiplied stream, each run
of equal keys is reduced: BLEND sums the channels, MAX keeps the element
with the strictly greatest w (the earlier element wins ties).  The run's
last slot keeps its key and the combined value; every other slot becomes
(INVALID, 0).

`combine_pack` is the counterpart of obj2voxel_tpu/ops/combine.py
`_combine_sorted_kernel` (K2, then K3, then the INVALID/zero tail): the
combined runs compacted in key order with their count, in one pass.  Every
slab merge of the engine runs it.

Each wrapper takes its plain version (`*_ref`) for CPU tensors and launches
the CUDA kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from . import _cuda
from .pack_pallas import pack_exact_ref
from .reduce_by_key import check_rows, reduce_by_key


def segment_combine_ref(sorted_keys, w, r, g, b, is_blend):
    """Plain version built from segment ids.

    BLEND is a per-run sum accumulated in float64 (`index_add_`) and
    rounded once, so it is the nearest float32 to the exact sum whatever
    order the device adds in; MAX keeps the first index that reaches the
    run's maximum weight.  No run sum is taken as a difference of
    cumsums."""
    P = sorted_keys.numel()
    dev = sorted_keys.device
    vals = torch.stack([w, r, g, b], dim=1)
    if P == 0:
        return sorted_keys.clone(), w.clone(), r.clone(), g.clone(), b.clone()
    head = torch.ones(P, dtype=torch.bool, device=dev)
    head[1:] = sorted_keys[1:] != sorted_keys[:-1]
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    n_seg = int(seg[-1]) + 1
    if is_blend:
        combined = torch.zeros((n_seg, 4), dtype=torch.float64, device=dev)
        combined.index_add_(0, seg, vals.to(torch.float64))
        combined = combined.to(vals.dtype)
    else:
        wmax = torch.full((n_seg,), float("-inf"), dtype=w.dtype, device=dev)
        wmax.scatter_reduce_(0, seg, w, reduce="amax")
        pos = torch.arange(P, dtype=torch.int64, device=dev)
        cand = torch.where(w == wmax[seg], pos, torch.full_like(pos, P))
        first = torch.full((n_seg,), P, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, seg, cand, reduce="amin")
        combined = vals[first]
    inv = torch.full_like(sorted_keys, _cuda.INVALID_KEY)
    nxt = inv.clone()
    nxt[:-1] = sorted_keys[1:]
    tail = (sorted_keys != nxt) & (sorted_keys != inv)
    out_k = torch.where(tail, sorted_keys, inv)
    out_v = torch.where(tail[:, None], combined[seg], torch.zeros_like(vals))
    return (out_k,) + tuple(out_v[:, j].contiguous() for j in range(4))


def segment_combine(sorted_keys, w, r, g, b, is_blend):
    """Tail-marked combine of a key-sorted stream; returns (keys', w', r',
    g', b') with the input's length."""
    chans = (w, r, g, b)
    check_rows("segment_combine", sorted_keys, chans)
    if sorted_keys.device.type == "cpu":
        return segment_combine_ref(sorted_keys, w, r, g, b, is_blend)
    out_k, outs, _ = reduce_by_key("segment_combine", sorted_keys, chans,
                                   combine=True, compact=False, is_blend=is_blend)
    return (out_k,) + outs


def combine_pack_ref(sorted_keys, chans, is_blend):
    """Plain version: K2's plain version, then K3's."""
    tk, *tv = segment_combine_ref(sorted_keys, *chans, is_blend)
    return pack_exact_ref(tk, tuple(tv))


def combine_pack(sorted_keys, chans, is_blend):
    """Combine a key-sorted premultiplied stream into its unique rows.

    Returns (keys (P,), chans 4-tuple, count (1,) int32 on the same
    device): the first `count` rows are the combined voxels in key order,
    the rest (INVALID, 0)."""
    check_rows("combine_pack", sorted_keys, chans)
    if sorted_keys.device.type == "cpu":
        return combine_pack_ref(sorted_keys, chans, is_blend)
    return reduce_by_key("combine_pack", sorted_keys, chans, combine=True,
                         compact=True, is_blend=is_blend)
