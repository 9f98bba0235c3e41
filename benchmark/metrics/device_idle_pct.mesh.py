"""device_idle_pct.mesh: the share of the traced window in which no
operation ran on the device, 100 (1 - busy / window), busy the union of
the device operations' intervals."""


def read(trace):
    if trace.busy_s <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
