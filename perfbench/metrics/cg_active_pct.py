"""``cg_active_pct``: the share of the PCG band's CG problems (the graphs
of a batch) still iterating at the loop's host looks, summed over the
looks of the traced ticks (``loop.pcg.cg.active`` over
``loop.pcg.cg.problems``): the useful share of the CG work; the rest
iterates frozen."""

from perfbench.lib import program_trace


def read(run):
    got = program_trace.store(run)
    if got is None:
        return None
    problems = got[1].get("loop.pcg.cg.problems", 0)
    if not problems:
        return None
    return 100.0 * got[1].get("loop.pcg.cg.active", 0) / problems
