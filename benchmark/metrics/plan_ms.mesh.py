"""plan_ms.mesh: host milliseconds of the port's plan stage a conversion
(`ops/plan_device.py`, or `ops/plan.py` on the host, then the plan-order
gather), from its O2V_TIMING lines: the end of its "plan" line less the
timing mode's own hint, which the port computes inside that stage before
planning and which no conversion outside timing mode pays.  Where no hint
line comes (the host planner), the whole stage, `engine.TIMING_S["plan"]`.
Mean over the conversions run under O2V_TIMING=1."""


def _plan_seconds(stages):
    hints = [end for name, _, end in stages if name == "hint"]
    total = 0.0
    for name, start, end in stages:
        if name == "plan":
            before = [h for h in hints if start <= h <= end]
            total += end - (max(before) if before else start)
    return total


def read(trace):
    values = [_plan_seconds(c.counters.get("stages", [])) for c in trace.staged]
    if not values or not all(values):
        return None
    return 1e3 * sum(values) / len(values)
