"""K2: tail-marked segmented combine (csrc/segment_combine.cu).

The counterpart of obj2voxel_tpu/ops/combine_pallas.py
`segment_combine_pallas`.  Over a key-sorted premultiplied stream, each run
of equal keys is reduced: BLEND sums the channels, MAX keeps the element
with the strictly greatest w (the earlier element wins ties).  The run's
last slot keeps its key and the combined value; every other slot becomes
(INVALID, 0).

`segment_combine` takes the plain version for CPU tensors and launches the
CUDA kernel for CUDA tensors; `segment_combine_ref` is the plain version.
"""

from __future__ import annotations

import torch

from . import _cuda

#: rows per scan tile (csrc/segment_combine.cu SC_TILE)
SC_TILE = 512


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
    if sorted_keys.dtype != torch.int32 or sorted_keys.dim() != 1:
        raise ValueError("segment_combine: keys must be a 1-D int32 tensor")
    for c in chans:
        if c.dtype != torch.float32 or c.shape != sorted_keys.shape:
            raise ValueError("segment_combine: channels must be float32 like keys")
    if sorted_keys.device.type == "cpu":
        return segment_combine_ref(sorted_keys, w, r, g, b, is_blend)
    dev = _cuda.require_cuda("segment_combine", sorted_keys, *chans)
    n = sorted_keys.numel()
    if n >= 1 << 31:
        raise ValueError("segment_combine: stream longer than int32 indexing")
    out_k = torch.empty_like(sorted_keys)
    outs = tuple(torch.empty_like(c) for c in chans)
    if n == 0:
        return (out_k,) + outs
    n_tiles = -(-n // SC_TILE)
    key_first = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    key_last = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    agg = torch.empty(4 * n_tiles, dtype=torch.float32, device=dev)
    carry = torch.empty(4 * n_tiles, dtype=torch.float32, device=dev)
    err = _cuda.lib().o2v_segment_combine(
        sorted_keys.data_ptr(), *(c.data_ptr() for c in chans),
        out_k.data_ptr(), *(o.data_ptr() for o in outs),
        key_first.data_ptr(), key_last.data_ptr(), agg.data_ptr(),
        carry.data_ptr(), n, int(bool(is_blend)), _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "segment_combine")
    _cuda.LAUNCHES["segment_combine"] += 1
    return (out_k,) + outs
