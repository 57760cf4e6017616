"""``pcg_hvp_pct``: the share of the PCG band's device time (the stream
time inside the span ``band.pcg``) spent in the CG body's
Hessian-vector products (the spans ``pcg.hvp`` inside it)."""

from perfbench.lib import program_trace


def read(run):
    return program_trace.device_share(run, "pcg.hvp", "band.pcg")
