"""``pcg_update_pct``: the share of the PCG band's device time (the stream
time inside the span ``band.pcg``) spent in the CG loop's vector updates
(the spans ``pcg.update`` inside it). Nothing where the program records no
such span."""

from perfbench.lib import program_trace


def read(run):
    return program_trace.device_share(run, "pcg.update", "band.pcg")
