"""dispatches.mesh: launches of passes a conversion (single K1 passes and
batched launches), `engine.WAVE_STATS["dispatches"]` read after each
traced conversion, mean over them."""


def read(trace):
    values = [c.counters.get("wave", {}).get("dispatches") for c in trace.conversions]
    if not values or None in values:
        return None
    return sum(values) / len(values)
