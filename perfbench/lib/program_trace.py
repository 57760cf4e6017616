"""The program's own spans and counters over a traced run.

``cg_mrslam_tpu_torch.utils.metrics`` records spans and counters only
while a torch profiler records, so in a ``--trace 1`` run they cover the
traced ticks and nothing else (the harness profiles whole ticks only).
A program that records none (a commit before them) gives nothing, and
so does an untraced run.
"""

from __future__ import annotations


def store(run, under: str | None = None):
    """``(span totals, counters)`` of the traced ticks: the span totals
    (``metrics.span_totals``, inside a span named ``under`` where given)
    and the counters; None where the run is untraced or the program
    recorded no span."""
    if run.trace is None:
        return None
    from cg_mrslam_tpu_torch.utils import metrics

    totals = getattr(metrics, "span_totals", None)
    counts = getattr(metrics, "counts", None)
    if totals is None or counts is None:
        return None
    spans = totals()
    if not spans:
        return None
    return (spans if under is None else totals(under)), counts()


def device_share(run, part: str, whole: str) -> float | None:
    """100 × the device seconds of the spans ``part`` inside the spans
    ``whole``, over the device seconds of ``whole``."""
    got = store(run, under=whole)
    if got is None:
        return None
    inside = got[0].get(part)
    total = store(run)[0].get(whole)
    if inside is None or total is None or total["device_s"] <= 0:
        return None
    return 100.0 * inside["device_s"] / total["device_s"]
