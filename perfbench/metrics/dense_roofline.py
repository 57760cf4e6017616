"""``dense_roofline``: the dense band's share of its roofline. The least
time the traced ticks' solves need (``perfbench/lib/roofline.py``: the
larger of their flops over the card's published float32 peak and their
bytes over its HBM rate) over the time the device was busy in them.
Nothing where the cell's band is not the dense one, or the card has no
published peak in the table."""

from perfbench.lib import roofline


def read(run):
    t, w = run.trace, run.cell.work()
    peak = roofline.peaks(run.device_name)
    if t is None or w["band"] != "dense" or peak is None or t.busy_s <= 0:
        return None
    graphs = run.cell.units() * t.n_ticks
    flops = graphs * roofline.dense_gn_flops(w["poses"], w["edges"],
                                             w["iterations"])
    nbytes = graphs * roofline.graph_bytes(w["poses"], w["edges"])
    return 100.0 * roofline.least_seconds(flops, nbytes, peak) / t.busy_s
