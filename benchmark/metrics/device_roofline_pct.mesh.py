"""device_roofline_pct.mesh: the least time the card could take for a
conversion over the device's busy time of one, in %.  The least time
reads each input triangle's three float32 vertices once (36 B) and writes
each output voxel's three int32 coordinates and ARGB word once (16 B), at
the card's published HBM bandwidth; whatever implements the conversion,
the work is counted so.  The FP32 bound of the clip needs the count of
(triangle, voxel) pairs, which the port does not expose."""

TRIANGLE_BYTES = 36
VOXEL_BYTES = 16


def read(trace):
    if trace.peaks is None or trace.busy_s <= 0 or not trace.n:
        return None
    work = sum(TRIANGLE_BYTES * c.work["triangles"] + VOXEL_BYTES * c.work["voxels"]
               for c in trace.conversions)
    return 100.0 * (work / trace.peaks["hbm_bytes_per_s"]) / trace.busy_s
