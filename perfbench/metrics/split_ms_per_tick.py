"""``split_ms_per_tick``: host milliseconds a tick in the band split of a
batch (the span ``solver.split`` less the band calls inside it: the
predicate's read, ``nonzero``, the gathers of each band's graphs and the
scatter back)."""

from perfbench.lib import program_trace


def read(run):
    got = program_trace.store(run)
    if got is None or "solver.split" not in got[0]:
        return None
    return 1e3 * got[0]["solver.split"]["self_s"] / run.trace.n_ticks
