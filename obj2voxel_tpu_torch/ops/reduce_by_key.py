"""The launcher of csrc/reduce_by_key.cu, the single-pass reduce-by-key that
K2 `segment_combine`, K3 `pack_exact` and their fusion `combine_pack` are
instances of.

One call allocates two int32 buffers and makes one C call.  The first
holds the five output rows (key, w, r, g, b) of n each, which the outputs
view.  The second holds the count and then, 16-byte aligned, the kernel's
scratch: per 4096-row tile two float4 slots of the run carry, a 64-bit
status word of the offset chain and a carry flag, and the chain's ticket;
the C launcher zeroes the flags and the ticket.  The count is a view of the
small buffer, so a caller that keeps it does not keep the rows alive.
"""

from __future__ import annotations

import torch

from . import _cuda

#: Rows per tile of the kernel (csrc/reduce_by_key.cu kRbkTile).
RBK_TILE = 4096


def aux_words(n):
    """int32 words of the small buffer: the count and a pad to 16 bytes,
    then the scratch, 44 bytes a tile and the 4-byte ticket."""
    return 4 + 11 * -(-n // RBK_TILE) + 1


def check_rows(name, keys, chans):
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError(f"{name}: keys must be a 1-D int32 tensor")
    if len(chans) != 4:
        raise ValueError(f"{name}: expected 4 value channels")
    for c in chans:
        if c.dtype != torch.float32 or c.shape != keys.shape:
            raise ValueError(f"{name}: channels must be float32 like keys")


def reduce_by_key(name, keys, chans, *, combine, compact, is_blend=False):
    """Launch the `combine`/`compact` instance on CUDA tensors: (keys',
    chans' 4-tuple, count (1,) int32).  With compact the rows are the
    output in order and (INVALID, 0) past the count; without, the
    tail-marked stream and a count that is not written."""
    dev = _cuda.require_cuda(name, keys, *chans)
    n = keys.numel()
    if n >= 1 << 31:
        raise ValueError(f"{name}: stream longer than int32 indexing")
    if n == 0:
        return (torch.empty_like(keys), tuple(torch.empty_like(c) for c in chans),
                torch.zeros(1, dtype=torch.int32, device=dev))
    rows = torch.empty(5 * n, dtype=torch.int32, device=dev)
    aux = torch.empty(aux_words(n), dtype=torch.int32, device=dev)
    p = rows.data_ptr()
    err = _cuda.lib().o2v_reduce_by_key(
        keys.data_ptr(), *(c.data_ptr() for c in chans),
        *(p + 4 * n * i for i in range(5)), aux.data_ptr(), aux.data_ptr() + 16,
        n, int(bool(combine)), int(bool(compact)), int(bool(is_blend)),
        _cuda.stream_ptr(dev),
    )
    _cuda.check(err, name)
    _cuda.count_launch(name)
    return (rows[:n], tuple(rows[i * n:(i + 1) * n].view(torch.float32)
                            for i in range(1, 5)), aux[:1])
