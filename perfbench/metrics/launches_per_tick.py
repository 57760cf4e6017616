"""``launches_per_tick``: kernels the device ran in the traced ticks, per
tick (the profiler's trace)."""


def read(run):
    t = run.trace
    if t is None:
        return None
    return t.count_device("kernel") / t.n_ticks
