"""Structured metrics, timing, and the solver's spans and counters.

Port of ``cg_mrslam_tpu/utils/metrics.py``: :class:`Recorder` is copied;
:func:`speed_of_light` keeps the reference's roofline arithmetic over the
port's own peaks table (:data:`CHIP_PEAKS`), which holds an NVIDIA H100
SXM's published figures only.

**Spans and counters.** :func:`span` and :func:`count` record only while a
torch profiler is recording (checked on every call with the profiler's
own flag; no option and no environment variable). Off, a span is one
shared null context and a count returns at once, so the solve path pays
one flag read per site. On, a span opens a ``record_function`` range (in
the profiler's trace, on its clock), records a pair of CUDA timing events
on the current stream where CUDA is in use (no kernel, no sync), and keeps
its name, its parent span and its host start and end in memory.
:func:`span_totals` and :func:`counts` read the store without clearing
it; :func:`reset` clears it. The store is this process's: it holds every
profiled stretch since the last :func:`reset`.
"""

from __future__ import annotations

import collections
import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import torch


class Recorder:
    """Append-only metric store: one record = (name, value, tags)."""

    def __init__(self) -> None:
        self._records: List[dict] = []

    def log(self, name: str, value: float, **tags) -> None:
        self._records.append(
            {"t": time.time(), "name": name, "value": float(value), **tags})

    @contextlib.contextmanager
    def timer(self, name: str, **tags) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.log(name, time.perf_counter() - t0, unit="s", **tags)

    def values(self, name: str) -> List[float]:
        return [r["value"] for r in self._records if r["name"] == name]

    def summary(self) -> Dict[str, dict]:
        """Per-metric count/mean/p50/p99/max."""
        import numpy as np

        by: Dict[str, list] = defaultdict(list)
        for r in self._records:
            by[r["name"]].append(r["value"])
        out = {}
        for k, v in by.items():
            a = np.asarray(v)
            out[k] = {
                "count": int(a.size),
                "mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99)),
                "max": float(a.max()),
            }
        return out

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self._records:
                f.write(json.dumps(r) + "\n")

    def __len__(self) -> int:
        return len(self._records)


_profiling = torch._C._autograd._profiler_enabled

# the counters of the profiled stretches (name -> total)
_COUNTS: collections.Counter = collections.Counter()
# one record a span: [name, parent index (-1: none), host start ns, host
# end ns, start event, end event (None: no CUDA in use)]
_SPANS: list = []
_OPEN: list = []                 # indices of the open spans, innermost last
_NULL = contextlib.nullcontext()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if _profiling():
        _COUNTS[name] += n


class _Span:
    __slots__ = ("name", "rf", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        start = None
        if torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        self.rec = [self.name, _OPEN[-1] if _OPEN else -1,
                    time.perf_counter_ns(), 0, start, None]
        _OPEN.append(len(_SPANS))
        _SPANS.append(self.rec)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec[3] = time.perf_counter_ns()
        if rec[4] is not None:
            rec[5] = torch.cuda.Event(enable_timing=True)
            rec[5].record()
        _OPEN.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context that records the span ``name`` while a profiler records
    (the shared null context otherwise)."""
    if not _profiling():
        return _NULL
    return _Span(name)


def counts() -> Dict[str, int]:
    """A copy of the counters."""
    return dict(_COUNTS)


def span_totals(under: str | None = None) -> Dict[str, dict]:
    """Per span name: ``calls``, ``host_s`` (host seconds from enter to
    exit), ``self_s`` (``host_s`` less its child spans') and ``device_s``
    (the stream time between the span's two events; the host seconds
    where no CUDA was in use, since CPU work runs on the host's clock).
    ``under`` keeps the spans inside a span of that name. Synchronizes
    the device once; the store is left as it is."""
    if any(r[5] is not None for r in _SPANS):
        torch.cuda.synchronize()
    child = [0] * len(_SPANS)
    for r in _SPANS:
        if r[1] >= 0:
            child[r[1]] += r[3] - r[2]
    out: Dict[str, dict] = {}
    for i, r in enumerate(_SPANS):
        if under is not None and not _inside(i, under):
            continue
        t = out.setdefault(r[0], {"calls": 0, "host_s": 0.0, "self_s": 0.0,
                                  "device_s": 0.0})
        host = (r[3] - r[2]) * 1e-9
        t["calls"] += 1
        t["host_s"] += host
        t["self_s"] += host - child[i] * 1e-9
        t["device_s"] += (host if r[4] is None
                          else r[4].elapsed_time(r[5]) * 1e-3)
    return out


def _inside(i: int, name: str) -> bool:
    p = _SPANS[i][1]
    while p >= 0:
        if _SPANS[p][0] == name:
            return True
        p = _SPANS[p][1]
    return False


def reset() -> None:
    """Clear the spans and counters."""
    _COUNTS.clear()
    _SPANS.clear()
    _OPEN.clear()


# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
# without sparsity, at the full 700 W power limit; a card set below it
# runs slower): float32 outside the tensor cores, TF32 and BF16 on the
# tensor cores, each beside the HBM3 rate. Published, not measured
# (``utils/sol.py`` measures the ceilings on the card).
CHIP_PEAKS = {
    "h100_sxm": {"flops": 67e12, "hbm_gbs": 3.35e12},
    "h100_sxm_tf32": {"flops": 495e12, "hbm_gbs": 3.35e12},
    "h100_sxm_bf16": {"flops": 989e12, "hbm_gbs": 3.35e12},
}
PEAKS_SOURCE = "published: NVIDIA H100 SXM data sheet (dense, 700 W)"


def speed_of_light(flops: float, bytes_moved: float, seconds: float,
                   chip: str = "h100_sxm") -> dict:
    """Roofline accounting against :data:`CHIP_PEAKS` ``[chip]``: the
    achieved fraction of the compute and bandwidth peaks, and which bound
    the work is closest to."""
    peak = CHIP_PEAKS[chip]
    f_frac = (flops / seconds) / peak["flops"] if seconds > 0 else 0.0
    b_frac = (bytes_moved / seconds) / peak["hbm_gbs"] if seconds > 0 else 0.0
    t_flops = flops / peak["flops"]
    t_bytes = bytes_moved / peak["hbm_gbs"]
    return {
        "seconds": seconds,
        "flops_frac_of_peak": f_frac,
        "bw_frac_of_peak": b_frac,
        "bound": "compute" if t_flops > t_bytes else "bandwidth",
        "sol_seconds": max(t_flops, t_bytes),
        "sol_frac": max(t_flops, t_bytes) / seconds if seconds > 0 else 0.0,
    }
