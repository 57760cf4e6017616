"""Cost of condense on one GPU, for comparing two versions of the port's
package in turns (the cost of a change to the solver's sums, say).

    python3 tools/bench_condense.py --save-state build/condense_state.npz
    python3 tools/bench_condense.py --state build/condense_state.npz \
        [--root DIR] [--tag NAME] [--reps 10] \
        [--out chiprun_out/condense.jsonl]

With ``--save-state``: drives the two-robot ``cg_mrslam`` default
deployment (``chip_smoke.py`` phase 6's configuration) on the card for
``--ticks`` ticks (330: robot 0's condense is on the PCG band there) and
saves robot 0's ``MRState`` (``convert.to_numpy``), so that every version
times the same state.

Otherwise: imports ``cg_mrslam_tpu_torch`` from ``--root`` (default: this
checkout; another version is unpacked into an ignored directory first,
e.g. ``mkdir -p build/prev_tree && git archive <commit> cg_mrslam_tpu_torch
| tar -x -C build/prev_tree``) and times, on the host clock with the card
synchronized around each call, after one warm-up call, ``--reps`` calls of:

1. ``condense`` on the merged two-robot fixture
   (``tests/fixtures/merged_2robot_1024.npz``, capacity 1024): robot 0's
   own edges, a boundary of every 16th own keyframe, under the chain
   order;
2. ``build_star`` of the saved state for robot 1.

Appends one JSON line (with ``--tag``, the card's name and power limit, the
package's path and the band each call took) to ``--out``. Run the versions
in turns (A, B, B, A) in one call and compare within it.

``--profile`` adds, for ``build_star``, a ``torch.profiler`` trace of three
calls: host wall ms, device busy ms (the sum of the kernels' device time;
one stream, so they do not overlap), the device's idle share, kernel
launches, and the ten kernels that take the most device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "merged_2robot_1024.npz"


def _timed(fn, reps: int) -> list:
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _merged_condense(dev):
    """A call of ``condense`` on the merged fixture (see the docstring)."""
    from cg_mrslam_tpu_torch.core import graph as G
    from cg_mrslam_tpu_torch.mr import condensed as CG
    from cg_mrslam_tpu_torch.solver import chain as CH

    d = np.load(FIXTURE)
    g = G.PoseGraph(*(torch.as_tensor(d[f]).to(dev) for f in (
        "poses", "vmask", "fixed", "e_ij", "e_z", "e_info", "emask",
        "e_level", "e_owner", "n_vertices", "n_edges")))
    vo, vr = d["v_owner"], d["v_remote"]
    own = np.flatnonzero(d["vmask"] & (vo == 0) & (vr % 16 == 8))
    boundary = torch.as_tensor(own, dtype=torch.int32, device=dev)
    valid = torch.ones(len(own), dtype=torch.bool, device=dev)
    order = CH.chain_order(torch.as_tensor(vo).to(dev),
                           torch.as_tensor(vr).to(dev), g.vmask)
    gauge = CG.select_gauge_centroid(g, boundary, valid)
    mask = G.own_edge_mask(g, 0)
    return lambda: CG.condense(g, boundary, valid, gauge, mask, order)


def _profile(fn, calls: int = 3) -> dict:
    """Host wall, device busy and idle share, launches and the top kernels
    of ``calls`` calls of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {"calls": calls, "wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall,
            "launches": sum(e.count for e in kernels),
            "top_kernels": [[e.key[:80], e.count,
                             e.self_device_time_total / 1e3] for e in top]}


def save_state(path: Path, ticks: int) -> None:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import deployment_config
    from cg_mrslam_tpu_torch import convert
    from cg_mrslam_tpu_torch.mr.sim import MultiRobotSim
    from cg_mrslam_tpu_torch.sim import world as W

    t0 = time.perf_counter()
    sim = MultiRobotSim(deployment_config(2),
                        W.hospital_world(40.0, 20.0, seed=0), beams=360,
                        max_range=10.0, seed=0, n_loops=2,
                        odom_noise=(0.01, 0.004), width=40.0, height=20.0)
    sim.run(max_ticks=ticks)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **convert.to_numpy(sim.states[0]))
    print(f"saved robot 0 at tick {ticks} "
          f"({int(sim.states[0].slam.graph.n_vertices)} vertices) to "
          f"{path} in {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save-state", type=Path)
    ap.add_argument("--ticks", type=int, default=330)
    ap.add_argument("--state", type=Path)
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--tag", default="current")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "condense.jsonl")
    a = ap.parse_args()
    if a.save_state:
        save_state(a.save_state, a.ticks)
        return 0
    sys.path.insert(0, str(a.root.resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import deployment_config
    import cg_mrslam_tpu_torch
    from cg_mrslam_tpu_torch import convert
    from cg_mrslam_tpu_torch.mr import mrslam as MR
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    rec = {"tag": a.tag, "package": str(Path(cg_mrslam_tpu_torch.__file__)
                                        .resolve().parent),
           "card": card}
    gn.BAND_CALLS.clear()
    rec["condense_merged_ms"] = _timed(_merged_condense(dev), a.reps)
    rec["condense_merged_bands"] = {f"{e}:{b}": n for (e, b), n in
                                    gn.BAND_CALLS.items()}
    st = convert.mr_state_from_numpy(dict(np.load(a.state)), dev)
    cap = deployment_config(2).mr.star_edges_cap
    gn.BAND_CALLS.clear()
    rec["build_star_ms"] = _timed(lambda: MR.build_star(st, 1, cap=cap),
                                  a.reps)
    rec["build_star_bands"] = {f"{e}:{b}": n for (e, b), n in
                               gn.BAND_CALLS.items()}
    if a.profile:
        rec["build_star_profile"] = _profile(
            lambda: MR.build_star(st, 1, cap=cap))
    for k in ("condense_merged_ms", "build_star_ms"):
        rec[k.replace("_ms", "_p50_ms")] = float(np.median(rec[k]))
    print(json.dumps(rec), flush=True)
    a.out.parent.mkdir(parents=True, exist_ok=True)
    with open(a.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
