"""``marginal_update_pct``: the share of an optimal-gauge star's marginal
covariances' device time (the stream time inside the spans
``condense.marginals``) spent in their CG loop's vector updates (the spans
``marginal.update`` inside them). Nothing where the program records no
such span."""

from perfbench.lib import program_trace


def read(run):
    return program_trace.device_share(run, "marginal.update",
                                      "condense.marginals")
