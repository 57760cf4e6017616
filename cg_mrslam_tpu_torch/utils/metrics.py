"""Structured metrics and timing.

Port of ``cg_mrslam_tpu/utils/metrics.py``: :class:`Recorder` is copied;
:func:`trace` is a ``torch.profiler`` scope; :func:`speed_of_light` keeps
the reference's roofline arithmetic over the port's own peaks table
(:data:`CHIP_PEAKS`), which holds an NVIDIA H100 SXM's published figures
only.
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
