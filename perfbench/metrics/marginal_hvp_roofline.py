"""``marginal_hvp_roofline``: the marginal solves' Hessian-vector product's
share of its roofline. The least time its bytes need at the card's
published HBM rate (``lib/roofline.peaks``) over the stream time inside
the spans ``marginal.hvp``. The bytes: one product a CG iteration
(``loop.pcg.marginal.iters``), each over the star's candidates, their
3K columns and the graph's slots, every input read once and the output
written once (``lib/hvp_work.py``): a lower bound, so the share stays
under 100%. Nothing where the cell is not an optimal-gauge star, the card
has no published peak or the program recorded no such span."""

from perfbench.lib import hvp_work, program_trace, roofline


def read(run):
    got = program_trace.store(run)
    peak = roofline.peaks(run.device_name)
    if got is None or peak is None:
        return None
    w = run.cell.work()
    span = got[0].get("marginal.hvp")
    iters = got[1].get("loop.pcg.marginal.iters", 0)
    if "candidates" not in w or span is None or span["device_s"] <= 0 \
            or not iters:
        return None
    b = w["candidates"]
    per_call = hvp_work.hvp_bytes(b, w["columns"], w["vertex_slots"],
                                  w["edge_slots"], 2 * w["own_edges"] * b)
    return 100.0 * iters * per_call / peak["hbm_bytes"] / span["device_s"]
