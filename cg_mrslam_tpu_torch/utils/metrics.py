"""Structured metrics and timing.

Port of ``cg_mrslam_tpu/utils/metrics.py``: :class:`Recorder` is copied;
:func:`trace` is a ``torch.profiler`` scope. The reference's roofline
table holds TPU peaks and has no counterpart here.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Iterator, List


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


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """``torch.profiler`` scope over CPU and CUDA activity; writes a Chrome
    trace (``trace.json``) into ``log_dir`` on exit."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
