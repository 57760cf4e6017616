"""Host cost of the two-robot global search on one GPU, for comparing two
versions of the port's package in turns.

    python3 tools/bench_search_host.py [--root DIR] [--ticks 360]
        [--calls 200] [--tag NAME] [--out chiprun_out/search_host.jsonl]

Imports ``cg_mrslam_tpu_torch`` from ``--root`` (default: this checkout;
another version is unpacked into an ignored directory first, e.g. ``mkdir
-p build/prev_tree && git archive <commit> cg_mrslam_tpu_torch | tar -x -C
build/prev_tree``) and:

1. drives the two-robot ``cg_mrslam`` default deployment (as
   ``chip_smoke.py`` phase 6 drives it) through ``MultiRobotSim`` for the
   first ``--ticks`` ticks, timing every ``try_match_parked`` by CUDA
   events around the call (``chip_smoke.py``'s metric) and by the host
   clock (no synchronization added), and counting K2's launches;
2. replays the last ``hierarchical_search`` call of that run (the global
   search with ``known_cap``: four K2 launches) ``--calls`` times: host
   clock per call without synchronization (``search_host_us``: what the
   host-bound round pays) and synchronized around each call
   (``search_sync_us``, p50).

Appends one JSON line (with ``--tag``, the card's name and power limit and
the package's path) to ``--out``. Run the versions in turns (A, B, B, A)
in one call and compare within it.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def deployment_config():
    """The ``cg_mrslam --nRobots 2`` CLI defaults, as ``chip_smoke.py``
    sets them."""
    from cg_mrslam_tpu_torch.config import (Config, MatcherConfig, MRConfig,
                                            SlamConfig)

    return Config(
        slam=SlamConfig(linear_update=0.25, angular_update=math.pi / 4,
                        min_inliers=7, window_loop_closure=10,
                        inlier_threshold=2.0),
        mr=MRConfig(n_robots=2, max_score_mr=0.15, min_inliers_mr=5,
                    window_mr_loop_closure=10, sim_comm_range=5.0),
        close_matcher=MatcherConfig(extent=30.0, resolution=0.025,
                                    kernel_radius=0.2, max_score=0.15),
        lc_matcher=MatcherConfig(extent=70.0, resolution=0.1,
                                 kernel_radius=0.5, max_score=0.15),
        max_vertices=512, max_edges=2048)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--ticks", type=int, default=360)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--tag", default="current")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "search_host.jsonl")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_search_host: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(a.root.resolve()))
    import cg_mrslam_tpu_torch
    from cg_mrslam_tpu_torch.mr import mrslam as MR
    from cg_mrslam_tpu_torch.mr.sim import MultiRobotSim
    from cg_mrslam_tpu_torch.ops import correlate as K
    from cg_mrslam_tpu_torch.sim import world as W

    pkg = Path(cg_mrslam_tpu_torch.__file__).parent
    if not pkg.is_relative_to(a.root.resolve()):
        raise RuntimeError(f"imported {pkg}, not the package under {a.root}")
    t0 = time.perf_counter()
    K.load_library()
    build_s = time.perf_counter() - t0

    world = W.hospital_world(40.0, 20.0, seed=0)
    sim = MultiRobotSim(deployment_config(), world, beams=360,
                        max_range=10.0, seed=0, n_loops=2,
                        odom_noise=(0.01, 0.004), width=40.0, height=20.0,
                        device="cuda")
    tmp, search = MR.try_match_parked, MR.hierarchical_search
    events, host_ms, last = [], [], {}

    def timed_tmp(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        h0 = time.perf_counter()
        out = tmp(*args, **kw)
        host_ms.append((time.perf_counter() - h0) * 1e3)
        e1.record()
        events.append((e0, e1))
        return out

    def captured_search(*args, **kw):
        last["call"] = (args, kw)
        return search(*args, **kw)

    MR.try_match_parked, MR.hierarchical_search = timed_tmp, captured_search
    K.SCORE_VOLUME_STRIDED.launches = 0
    t0 = time.perf_counter()
    try:
        sim.run(max_ticks=a.ticks)
    finally:
        MR.try_match_parked, MR.hierarchical_search = tmp, search
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2 = K.SCORE_VOLUME_STRIDED.launches
    ev_ms = [e0.elapsed_time(e1) for e0, e1 in events]

    args, kw = last["call"]
    call = lambda: search(*args, **kw)  # noqa: E731
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(a.calls):
        call()
    search_host_us = (time.perf_counter() - h0) / a.calls * 1e6
    sync_us = []
    for _ in range(a.calls):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        sync_us.append((time.perf_counter() - h0) * 1e6)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    row = {
        "tag": a.tag, "package": str(pkg), "card": card,
        "build_s": build_s, "ticks": a.ticks, "wall_s": wall,
        "try_match_parked_calls": len(ev_ms), "k2_launches": k2,
        "try_match_parked_event_ms_p50": float(np.percentile(ev_ms, 50)),
        "try_match_parked_event_ms_mean": float(np.mean(ev_ms)),
        "try_match_parked_host_ms_p50": float(np.percentile(host_ms, 50)),
        "try_match_parked_host_ms_mean": float(np.mean(host_ms)),
        "search_host_us": search_host_us,
        "search_sync_us_p50": float(np.percentile(sync_us, 50)),
    }
    print(json.dumps(row), flush=True)
    a.out.parent.mkdir(parents=True, exist_ok=True)
    with open(a.out, "a") as f:
        f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
