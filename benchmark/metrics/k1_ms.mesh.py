"""k1_ms.mesh: device milliseconds a conversion of the fused pass K1
(`ops/pass_fused.py` -> `csrc/fused_pass.cu`: its pass kernel, every
kernel whose name holds "fused_pass", and the ordered compaction that it
launches after it, `csrc/o2v_compact.cuh`'s `exclusive_scan_kernel` and
`scatter_kernel`), from the profiler's trace, mean over the traced
conversions."""

PARTS = ("fused_pass", "::exclusive_scan_kernel(", "::scatter_kernel(")


def read(trace):
    seconds = sum(trace.kernel_seconds(part) for part in PARTS)
    if seconds <= 0 or not trace.n:
        return None
    return 1e3 * seconds / trace.n
