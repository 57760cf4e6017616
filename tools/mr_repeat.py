"""Repeat the two-robot ``cg_mrslam`` default deployment on one GPU and say
whether the runs are bit-identical.

    python3 tools/mr_repeat.py [--runs 2] [--out chiprun_out/mr_repeat.jsonl]

Drives ``chip_smoke.py`` phase 6's deployment (``chip_smoke.run_mr``) through
``MultiRobotSim`` on the card ``--runs`` times in one process. For each run
it prints (and appends as a JSON line, with the card's name and power limit)
every robot's final chi2, keyframes, inter-robot closures and star edges,
the wall seconds, and whether every robot's graph (poses, edges,
information, masks) and every keyframe's ``StepInfo`` equal the first run's
bit for bit.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "mr_repeat.jsonl")
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    first = None
    a.out.parent.mkdir(parents=True, exist_ok=True)
    for k in range(a.runs):
        t0 = time.perf_counter()
        sim, _, _ = C.run_mr("cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        graphs = [{f: getattr(st.slam.graph, f).cpu().numpy() for f in (
            "poses", "e_ij", "e_z", "e_info", "emask", "vmask", "e_level",
            "e_owner")} for st in sim.states]
        infos = [[np.asarray(tuple(i.pose) + (i.chi2, i.closures_added))
                  for i in r] for r in sim.infos]
        if first is None:
            first = (graphs, infos)
        same = all(np.array_equal(g[f], h[f]) for g, h in zip(graphs,
                                                              first[0])
                   for f in g) and all(
            len(x) == len(y) and all(np.array_equal(p, q)
                                     for p, q in zip(x, y))
            for x, y in zip(infos, first[1]))
        outs = [C.outcomes(st) for st in sim.states]
        rec = {"run": k, "card": card, "wall_s": wall,
               "identical_to_run_0": bool(same),
               "final_chi2": [r[-1].chi2 for r in sim.infos],
               "keyframes": [len(r) for r in sim.infos],
               "inter_closures": [o["inter_closures"] for o in outs],
               "star_edges": [o["star_edges"] for o in outs]}
        print(json.dumps(rec), flush=True)
        with open(a.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
