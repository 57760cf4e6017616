"""The benchmark's runner: one cell, one run, one JSON line.

Everything that belongs to one configuration, traffic mix, workload kind
or metric lives in files of its own, found here by the names in
``BENCHMARK.json``:

* ``<config file>`` (the cell's ``config`` entry names it): the deployment;
* ``perfbench/workloads/<traffic>.json``: the traffic mix, whose ``kind``
  names the module ``perfbench/kinds/<kind>.py`` that runs it;
* ``perfbench/limits/<workload>.json``: the cell's correctness limits;
* ``perfbench/metrics/<metric>.py``: one reader per metric.

A run: set-up (the kind builds its inputs from the seed and warms every
shape it will use), then a closed-loop window of whole ticks of at least
``--seconds``, then the check against the plain reference once the
program's state is freed. ``--trace 1`` profiles a fixed number of whole
ticks inside the window and reports the per-layer metrics instead of the
end-to-end ones.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
OUT = HERE / "out"
# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "cg_mrslam_tpu")


def load_module(path: Path, name: str):
    """The module in ``path`` (found by the name in ``BENCHMARK.json``)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return p.stdout.strip().splitlines()[0] if p.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


class Spec:
    """A cell as ``BENCHMARK.json`` and its files define it."""

    def __init__(self, root: Path, workload: str):
        bench = read_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        cfg = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.config = read_json(root / cfg["file"])
        self.traffic = read_json(HERE / "workloads"
                                 / f"{self.workload['traffic']}.json")
        self.limits = read_json(HERE / "limits" / f"{workload}.json")
        self.kind = load_module(HERE / "kinds"
                                / f"{self.traffic['kind']}.py",
                                self.traffic["kind"])

        def mine(m):
            return workload in m.get("workloads", [workload])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


class Run:
    """What a metric's reader sees: the cell, the window's ticks on the
    host clock, the set-up time and, in a traced run, the trace."""

    def __init__(self, spec: Spec, cell, setup_s: float):
        self.spec = spec
        self.cell = cell
        self.setup_s = setup_s
        self.tick_s: list = []
        self.window_s = 0.0
        self.trace = None
        self.device_name = ""


def window(run: Run, seconds: float, trace: bool) -> None:
    """Closed-loop ticks until ``seconds`` have passed, each tick whole;
    with ``trace``, the profiler over ticks ``skip .. skip + n - 1``."""
    import torch

    from perfbench.lib import trace as tr

    skip = int(run.spec.traffic.get("trace_skip", 1))
    n = int(run.spec.traffic.get("trace_ticks", 3))
    prof = None
    t = 0
    start = time.perf_counter()
    while True:
        if trace and t == skip:
            prof = tr.start()
        scope = (torch.profiler.record_function(tr.TICK) if prof is not None
                 else contextlib.nullcontext())
        a = time.perf_counter()
        with scope:
            run.cell.tick(t)
        b = time.perf_counter()
        run.tick_s.append(b - a)
        t += 1
        if prof is not None and t == skip + n:
            run.trace = tr.stop(prof)
            prof = None
        if b - start >= seconds and prof is None:
            break
    run.window_s = b - start


def read_metrics(run: Run, entries: list) -> dict:
    out = {}
    for m in entries:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py", m["name"])
        v = reader.read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def result_line(run: Run, traced: bool, chips: int, peak: int,
                card: str) -> dict:
    """The result's line before the check: the cell's end-to-end metrics
    (``traced`` false) or per-layer ones, the device, and in a traced run
    the breakdown of the trace."""
    metrics = read_metrics(run, run.spec.per_layer if traced
                           else run.spec.end_to_end)
    device = {"platform": "gpu", "kind": run.device_name, "count": chips,
              "memory_peak_bytes": peak, "power_limit": card}
    result = {"correct": False, "attempted": run.cell.attempted(),
              "failed": run.cell.failed(), "metrics": metrics,
              "device": device}
    if traced:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    return result


def run_cell(spec: Spec, seed: int, seconds: float, traced: bool,
             t0: float, device: str = "cuda", card: str = ""):
    """All of a run but its look for a card and its output: set-up, the
    window, the result's line and the check. Returns ``(result,
    checks)``."""
    import torch

    on_card = torch.device(device).type == "cuda"
    cell = spec.kind.Cell(spec.config, spec.traffic, spec.limits, seed,
                          device=device)
    cell.setup()
    if traced:
        from perfbench.lib import trace as tr
        tr.warm()
    if on_card:
        torch.cuda.synchronize()
    run = Run(spec, cell, time.perf_counter() - t0)
    run.device_name = (torch.cuda.get_device_name(0) if on_card
                       else str(device))
    window(run, seconds, traced)
    peak = 0
    if on_card:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    ticks = sorted(run.tick_s)
    print(f"perfbench: set-up {run.setup_s:.3f} s, window "
          f"{run.window_s:.3f} s, {len(ticks)} ticks (ms: min "
          f"{1e3 * ticks[0]:.1f}, median {1e3 * ticks[len(ticks) // 2]:.1f}, "
          f"max {1e3 * ticks[-1]:.1f})", file=sys.stderr, flush=True)
    result = result_line(run, traced, int(spec.workload["chips"]), peak,
                         card)
    checks = cell.check()               # frees the program's state first
    result["correct"] = all(c["ok"] for c in checks)
    # a comparison that reads no number (NaN) has failed; JSON has no NaN
    result["checks"] = {
        c["name"]: {"value": c["value"] if math.isfinite(c["value"])
                    else None, "limit": c["limit"]} for c in checks}
    return result, checks


def main(argv, root: Path, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's build and kernel caches: fixed directories inside the
    # checkout, so that only a cell's first run there builds anything
    os.environ["TORCH_EXTENSIONS_DIR"] = str(OUT / "cache" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(OUT / "cache" / "triton")

    spec = Spec(root, args.workload)
    import torch

    chips = int(spec.workload["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); {found} "
              "found", file=sys.stderr)
        return 2

    card = power_limit()
    print(f"perfbench: {args.workload} seed {args.seed} on {card}",
          file=sys.stderr, flush=True)
    result, checks = run_cell(spec, args.seed, args.seconds,
                              bool(args.trace), t0, "cuda", card)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}, "
              f"{'ok' if c['ok'] else 'FAIL'})", file=sys.stderr)
    sys.stderr.flush()
    return 0
