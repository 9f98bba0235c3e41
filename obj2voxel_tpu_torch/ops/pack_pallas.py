"""Order-preserving compaction of (key, 4 channels) streams.

K3 `pack_exact`, the counterpart of obj2voxel_tpu/ops/pack_pallas.py
`pack_exact_pallas`: rows with key != INVALID move to a dense prefix in
input order, and the count comes back as a (1,) int32 tensor.  It is the
compact-only instance of the reduce-by-key csrc/reduce_by_key.cu
(ops/reduce_by_key.py).

K5 `pack_channels` (csrc/pack_channels.cu), the counterpart of
`pack_channels_pallas`: the same per 8192-slot block, each block's live rows
at a running offset that advances by the block's live count rounded up to
128 rows, the gaps filled with (INVALID, 0); the count is the final offset.
No engine path calls it.

Unlike the TPU kernels, rows past the count are (INVALID, 0), never
undefined.  Each wrapper takes its plain version (`*_ref`) for CPU tensors
and launches its CUDA kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from . import _cuda
from .reduce_by_key import check_rows, reduce_by_key

#: Slots per block of `pack_channels`, and the row granularity of its offsets.
PACK_BLOCK = 8192
PACK_ROW = 128


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


def pack_exact(keys, vals):
    """Compact (keys, 4 float32 channels) to an exactly dense live prefix.

    Returns (keys', vals' 4-tuple, count (1,) int32 tensor on the same
    device); rows past count are (INVALID, 0)."""
    check_rows("pack_exact", keys, vals)
    if keys.device.type == "cpu":
        return pack_exact_ref(keys, vals)
    return reduce_by_key("pack_exact", keys, vals, combine=False, compact=True)


def pack_channels_ref(keys, vals):
    """Plain version of the block-prefix layout: (keys', vals' tuple, count
    (1,) int32)."""
    live = (keys != _cuda.INVALID_KEY).reshape(-1, PACK_BLOCK)
    per_block = live.sum(dim=1)
    rounded = (per_block + PACK_ROW - 1) // PACK_ROW * PACK_ROW
    base = torch.cumsum(rounded, 0) - rounded
    # destination of each live row: its block's offset + its rank in the block
    rank = torch.cumsum(live.to(torch.int64), dim=1) - 1
    dst = (base[:, None] + rank)[live]
    src = torch.nonzero(live.reshape(-1)).flatten()
    out_k = torch.full_like(keys, _cuda.INVALID_KEY)
    out_k[dst] = keys[src]
    outs = []
    for v in vals:
        o = torch.zeros_like(v)
        o[dst] = v[src]
        outs.append(o)
    return out_k, tuple(outs), rounded.sum().reshape(1).to(torch.int32)


def pack_channels(keys, vals):
    """Compact (keys, 4 float32 channels) into the block-prefix layout; the
    length must be a multiple of PACK_BLOCK.

    Returns (keys', vals' 4-tuple, count (1,) int32 tensor on the same
    device); rows past count are (INVALID, 0)."""
    check_rows("pack_channels", keys, vals)
    n = keys.numel()
    if n % PACK_BLOCK:
        raise ValueError(f"pack_channels: length {n} is not a multiple of {PACK_BLOCK}")
    if keys.device.type == "cpu":
        return pack_channels_ref(keys, vals)
    dev = _cuda.require_cuda("pack_channels", keys, *vals)
    if n >= 1 << 31:
        raise ValueError("pack_channels: stream longer than int32 indexing")
    if n == 0:
        return keys.clone(), tuple(v.clone() for v in vals), torch.zeros(
            1, dtype=torch.int32, device=dev)
    # one buffer: the five output rows, the count and a pad, then the
    # look-back's status word of each block and its ticket, which the
    # launcher zeroes; the pointers are offsets into it
    n_blocks = n // PACK_BLOCK
    buf = torch.empty(5 * n + 2 * n_blocks + 4, dtype=torch.int32, device=dev)
    p = buf.data_ptr()
    err = _cuda.lib().o2v_pack_channels(
        keys.data_ptr(), *(v.data_ptr() for v in vals),
        *(p + 4 * n * i for i in range(5)), p + 20 * n, p + 20 * n + 8, n,
        _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "pack_channels")
    _cuda.count_launch("pack_channels")
    return (buf[:n], tuple(buf[i * n:(i + 1) * n].view(torch.float32) for i in range(1, 5)),
            buf[5 * n:5 * n + 1])
