"""``star_marginal_pct``: the share of an optimal-gauge star's device time
(the stream time inside the span ``star.optimal``) spent in the
candidates' marginal covariances (the spans ``condense.marginals`` inside
it); the rest is the settle, the labeling and the batch's set-up."""

from perfbench.lib import program_trace


def read(run):
    return program_trace.device_share(run, "condense.marginals",
                                      "star.optimal")
