"""K3: exact order-preserving compaction (csrc/pack_exact.cu).

The counterpart of obj2voxel_tpu/ops/pack_pallas.py `pack_exact_pallas`:
(key, 4 channels) rows with key != INVALID move to a dense prefix in input
order, and the count comes back as a (1,) int32 tensor.  Unlike the TPU
kernel, rows past the count are (INVALID, 0), never undefined.

`pack_exact` takes the plain version for CPU tensors and launches the CUDA
kernel for CUDA tensors; `pack_exact_ref` is the plain version.
"""

from __future__ import annotations

import torch

from . import _cuda

def pack_exact_ref(keys, vals):
    """Plain version: (keys', vals' tuple, count (1,) int32)."""
    live = keys != _cuda.INVALID_KEY
    idx = torch.nonzero(live).flatten()
    n = idx.numel()
    out_k = torch.full_like(keys, _cuda.INVALID_KEY)
    out_k[:n] = keys[idx]
    outs = []
    for v in vals:
        o = torch.zeros_like(v)
        o[:n] = v[idx]
        outs.append(o)
    count = torch.tensor([n], dtype=torch.int32, device=keys.device)
    return out_k, tuple(outs), count


def _check(keys, vals):
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError("pack_exact: keys must be a 1-D int32 tensor")
    if len(vals) != 4:
        raise ValueError("pack_exact: expected 4 value channels")
    for v in vals:
        if v.dtype != torch.float32 or v.shape != keys.shape:
            raise ValueError("pack_exact: channels must be float32 like keys")


def pack_exact(keys, vals):
    """Compact (keys, 4 float32 channels) to an exactly dense live prefix.

    Returns (keys', vals' 4-tuple, count (1,) int32 tensor on the same
    device); rows past count are (INVALID, 0)."""
    _check(keys, vals)
    if keys.device.type == "cpu":
        return pack_exact_ref(keys, vals)
    dev = _cuda.require_cuda("pack_exact", keys, *vals)
    n = keys.numel()
    if n >= 1 << 31:
        raise ValueError("pack_exact: stream longer than int32 indexing")
    out_k = torch.empty_like(keys)
    outs = tuple(torch.empty_like(v) for v in vals)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    if n == 0:
        return out_k, outs, count
    n_tiles = -(-n // _cuda.COMPACT_TILE)
    tile_counts = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    tile_offsets = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    err = _cuda.lib().o2v_pack_exact(
        keys.data_ptr(), *(v.data_ptr() for v in vals),
        out_k.data_ptr(), *(o.data_ptr() for o in outs),
        count.data_ptr(), tile_counts.data_ptr(), tile_offsets.data_ptr(),
        n, _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "pack_exact")
    _cuda.LAUNCHES["pack_exact"] += 1
    return out_k, outs, count
