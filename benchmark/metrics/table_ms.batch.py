"""table_ms.batch: host milliseconds a batch of the table build and its
upload (`engine.voxelize_grid` -> `host_table`, then the copy to the
device), from `engine.TIMING_S["table"]`, mean over the batches run under
O2V_TIMING=1."""


def read(trace):
    values = [c.counters.get("timing_s", {}).get("table") for c in trace.staged]
    if not values or None in values:
        return None
    return 1e3 * sum(values) / len(values)
