"""``dense_assembly_pct``: the share of the dense band's device time (the
stream time inside the span ``band.dense``) spent linearizing and
assembling the normal equations by one-hot products (the spans
``gn.linearize`` inside it)."""

from perfbench.lib import program_trace


def read(run):
    return program_trace.device_share(run, "gn.linearize", "band.dense")
