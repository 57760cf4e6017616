"""``tick_p90_ms``: the 90th percentile of the window's tick times (host
clock, ms): how long each robot waits for its update. Reported where the
window holds at least 100 ticks, so that ten lie beyond it."""

import numpy as np


def read(run):
    if len(run.tick_s) < 100:
        return None
    return 1e3 * float(np.quantile(np.asarray(run.tick_s), 0.9))
