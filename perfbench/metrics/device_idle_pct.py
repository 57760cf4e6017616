"""``device_idle_pct``: the share of the traced ticks' wall time that no
kernel, copy or fill on the device covers (the union of their intervals,
from the profiler's trace)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
