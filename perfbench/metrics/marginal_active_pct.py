"""``marginal_active_pct``: the share of the marginal solves' CG columns
(one a boundary coordinate, for every candidate gauge) still iterating at
the loop's host looks, summed over the looks of the traced ticks
(``loop.pcg.marginal.active`` over ``loop.pcg.marginal.problems``): the
useful share of the marginals' CG work; the rest iterates frozen."""

from perfbench.lib import program_trace


def read(run):
    got = program_trace.store(run)
    if got is None:
        return None
    problems = got[1].get("loop.pcg.marginal.problems", 0)
    if not problems:
        return None
    return 100.0 * got[1].get("loop.pcg.marginal.active", 0) / problems
