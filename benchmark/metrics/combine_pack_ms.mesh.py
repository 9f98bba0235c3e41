"""combine_pack_ms.mesh: device milliseconds a conversion of the slab
merges' reduce-by-key (`combine_pack`, `csrc/reduce_by_key.cu`: every
kernel whose name holds "rbk_", the tile pass and its tail fill), from the
profiler's trace, mean over the traced conversions."""


def read(trace):
    seconds = trace.kernel_seconds("rbk_")
    if seconds <= 0 or not trace.n:
        return None
    return 1e3 * seconds / trace.n
