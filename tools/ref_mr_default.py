"""Run the JAX reference's two-robot ``cg_mrslam`` default deployment (all
robots in one process) and report each robot's outcome.

    JAX_PLATFORMS=cpu python tools/ref_mr_default.py --dir build/ref_mr \
        [--ticks 0] [--out build/ref_mr/outcome.json]

Runs ``python -m cg_mrslam_tpu cg_mrslam --nRobots 2 --modality sim -o ref``
in process (``cg_mrslam_tpu.cli.main``) inside ``--dir``, recording each
robot's keyframe ticks and the chi2 of its last keyframe step, and printing
its progress every 20 exchange rounds. Then it loads
each robot's ``robot-<r>-ref.g2o`` and prints, per robot: the last keyframe's
chi2 (what ``chip_smoke.py`` phase 6 prints for the port), the chi2 of the
saved graph, the ATE of its own keyframes and the odometry-only ATE, the
inter-robot closures and star edges. The outcome also goes to ``--out`` as
JSON. The port's default deployment ends at chi2 39.6076 (robot 0) and
2694.3843 (robot 1) on the H100; this is the reference's answer to the same
question.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def ate(est: np.ndarray, gt: np.ndarray) -> float:
    """RMS translation error after aligning the first pose."""
    def compose(a, b):
        c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
        return np.stack([a[..., 0] + c * b[..., 0] - s * b[..., 1],
                         a[..., 1] + s * b[..., 0] + c * b[..., 1],
                         a[..., 2] + b[..., 2]], -1)

    e0 = est[0].astype(np.float64)
    c, s = np.cos(e0[2]), np.sin(e0[2])
    inv = np.array([-(c * e0[0] + s * e0[1]), -(-s * e0[0] + c * e0[1]),
                    -e0[2]])
    aligned = compose(compose(gt[0], inv), est.astype(np.float64))
    return float(np.sqrt(np.mean(np.sum((aligned[:, :2] - gt[:, :2]) ** 2,
                                        axis=1))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", type=Path, default=ROOT / "build" / "ref_mr")
    ap.add_argument("--ticks", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    a = ap.parse_args()

    from cg_mrslam_tpu import cli
    from cg_mrslam_tpu.core.linearize import chi2
    from cg_mrslam_tpu.io import g2o
    from cg_mrslam_tpu.mr import sim as MS

    seen = {}
    last_chi2 = {}
    run, step = MS.MultiRobotSim.run, MS.keyframe_step
    exchange = MS.MultiRobotSim.exchange_round
    t0 = time.perf_counter()

    def keep(self, *args, **kw):
        seen["sim"] = self
        return run(self, *args, **kw)

    def progress(self, t, *args, **kw):
        out = exchange(self, t, *args, **kw)
        seen["rounds"] = seen.get("rounds", 0) + 1
        if seen["rounds"] % 20 == 0:
            print(f"round {seen['rounds']} at tick {t}: keyframes "
                  f"{[len(k) - 1 for k in self.kf_gt]}, "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
        return out

    def recording_step(state, est, ranges, cfg):
        out = step(state, est, ranges, cfg)
        last_chi2[int(state.my_id)] = float(out[1].chi2)
        return out

    MS.MultiRobotSim.run, MS.keyframe_step = keep, recording_step
    MS.MultiRobotSim.exchange_round = progress
    a.dir.mkdir(parents=True, exist_ok=True)
    os.chdir(a.dir)
    argv = ["cg_mrslam", "--nRobots", "2", "--modality", "sim", "-o", "ref"]
    if a.ticks:
        argv += ["--ticks", str(a.ticks)]
    cli.main(argv)
    wall = time.perf_counter() - t0
    sim = seen["sim"]
    out = {"argv": argv, "wall_s": wall, "robots": []}
    for r in range(sim.R):
        lg = g2o.load(f"robot-{r}-ref.g2o", native=False)
        g = lg.graph
        ids = lg.ids
        own = np.flatnonzero(ids // 10000 == r)
        own = own[np.argsort(ids[own])]
        est = np.asarray(g.poses)[own]
        kf_gt = np.asarray(sim.kf_gt[r])
        tr = sim.trajs[r]
        ticks = [int(np.flatnonzero((tr.gt == p).all(1))[0]) for p in kf_gt]
        em = np.asarray(g.emask)
        ij = np.asarray(g.e_ij)[em]
        lvl = np.asarray(g.e_level)[em]
        vo = np.where(ids >= 0, ids // 10000, -1)
        rec = {
            "robot": r, "keyframes": len(kf_gt) - 1,
            "last_keyframe_chi2": last_chi2.get(r),
            "graph_chi2": float(chi2(g)),
            "ate_m": ate(est, kf_gt),
            "odometry_ate_m": ate(np.asarray(tr.odom)[ticks], kf_gt),
            "inter_closures": int(((vo[ij[:, 0]] != vo[ij[:, 1]])
                                   & (lvl == 0)).sum()),
            "star_edges": int((lvl > 0).sum())}
        out["robots"].append(rec)
        print(json.dumps(rec), flush=True)
    print(f"wall {wall:.1f} s", flush=True)
    if a.out:
        a.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
