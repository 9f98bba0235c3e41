"""prep_split_ms.batch: host milliseconds a batch outside every stage line
of the port (`engine.TIMING_S` under O2V_TIMING=1): the batch's wall time
less its table, plan, passes, merges and pulls.  That is `voxelize_batch`'s
per-mesh `prepare_soup`, its z stacking and `split_by_mesh`, and the
stream's own host work between stages; the port has no span of its own for
them yet.  Mean over the batches run under O2V_TIMING=1."""


def read(trace):
    values = []
    for c in trace.staged:
        stages = c.counters.get("timing_s")
        if not stages:
            return None
        values.append(c.wall_s - sum(stages.values()))
    return 1e3 * sum(values) / len(values) if values else None
