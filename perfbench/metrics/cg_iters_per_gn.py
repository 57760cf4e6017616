"""``cg_iters_per_gn``: CG iterations the PCG band ran per Gauss–Newton
iteration in the traced ticks (``loop.pcg.cg.iters`` over
``gn.iters.pcg``). A batch runs until its last graph stops, so this is
the loop's length, not each graph's need (``cg_active_pct``)."""

from perfbench.lib import program_trace


def read(run):
    got = program_trace.store(run)
    if got is None:
        return None
    gn = got[1].get("gn.iters.pcg", 0)
    if not gn:
        return None
    return got[1].get("loop.pcg.cg.iters", 0) / gn
