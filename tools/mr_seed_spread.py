"""Outcome spread of the two-robot ``MultiRobotSim`` over trajectory seeds,
in the JAX reference and in the PyTorch port, on the CPU.

    python tools/mr_seed_spread.py --seeds 11 12 13 14 [--ticks 700]

The deployment is ``tests/test_mrslam.py``'s (16 x 10 m hospital world,
seed 2, 120 beams, capacity 192/1024, comm range 6 m); each seed draws new
odometry noise for both robots. Both packages replay the same scans (the
reference simulator's). Per seed, package and robot it prints the final
graph's chi2, the ATE of the robot's own keyframes (first pose aligned),
the inter-robot closures and star edges it holds, and the cross-robot
agreement (``tests/test_mrslam.py``'s: distance between the robot's
estimate of a constrained foreign vertex and its owner's own), then one
JSON line per seed. It asks whether the reference, too, sometimes settles
on a large-chi2, disagreeing outcome, and whether the port lands on the
reference's outcome seed by seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cg_mrslam_tpu import config as JC  # noqa: E402
from cg_mrslam_tpu.core.linearize import chi2 as jchi2  # noqa: E402
from cg_mrslam_tpu.mr import sim as JMS  # noqa: E402
from cg_mrslam_tpu.sim import world as JW  # noqa: E402
from cg_mrslam_tpu_torch import config as TC  # noqa: E402
from cg_mrslam_tpu_torch.core.linearize import chi2 as tchi2  # noqa: E402
from cg_mrslam_tpu_torch.mr import sim as TMS  # noqa: E402


def build_config(m):
    return m.Config(
        slam=m.SlamConfig(min_inliers=4, window_loop_closure=8),
        mr=m.MRConfig(n_robots=2, min_inliers_mr=4, sim_comm_range=6.0,
                      max_score_mr=0.2),
        close_matcher=m.MatcherConfig(extent=16.0, resolution=0.05,
                                      kernel_radius=0.2),
        lc_matcher=m.MatcherConfig(extent=24.0, resolution=0.1,
                                   kernel_radius=0.5),
        max_vertices=192, max_edges=1024)


def host(st) -> dict:
    """A robot's state as numpy arrays."""
    g = st.slam.graph
    return {k: np.asarray(v) for k, v in (
        ("poses", g.poses), ("vmask", g.vmask), ("emask", g.emask),
        ("e_ij", g.e_ij), ("e_level", g.e_level),
        ("owner", st.slam.v_owner), ("remote", st.slam.v_remote),
        ("me", st.slam.my_id))}


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


def robot_outcome(h: dict, other: dict, kf_gt) -> dict:
    me = int(h["me"])
    vm, vo, vr = h["vmask"], h["owner"], h["remote"]
    ij, lvl = h["e_ij"][h["emask"]], h["e_level"][h["emask"]]
    own = np.flatnonzero(vm & (vo == me))
    est = h["poses"][own[np.argsort(vr[own])]]
    deg = np.bincount(ij.reshape(-1), minlength=len(vm))
    gid = int(other["me"])
    errs = []
    for slot in np.flatnonzero(vm & (vo == gid) & (deg > 0)):
        m = other["vmask"] & (other["owner"] == gid) \
            & (other["remote"] == vr[slot])
        if m.any():
            errs.append(float(np.hypot(*(h["poses"][slot, :2]
                                         - other["poses"][np.argmax(m),
                                                          :2]))))
    e = np.asarray(errs)
    gt = np.asarray(kf_gt)[:len(est)]
    return {"ate": ate(est, gt),
            "inter_closures": int(((vo[ij[:, 0]] != vo[ij[:, 1]])
                                   & (lvl == 0)).sum()),
            "star_edges": int((lvl > 0).sum()),
            "agree_median": float(np.median(e)) if len(e) else None,
            "agree_max": float(e.max()) if len(e) else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[11, 12, 13, 14])
    ap.add_argument("--ticks", type=int, default=700)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    jcfg, tcfg = build_config(JC), build_config(TC)
    world = JW.hospital_world(width=16.0, height=10.0, seed=2)
    for seed in args.seeds:
        row = {"seed": seed}
        t0 = time.perf_counter()
        jsim = JMS.MultiRobotSim(jcfg, world, beams=120, seed=seed,
                                 n_loops=2, width=16.0, height=10.0)
        jsim.run(max_ticks=args.ticks)
        t1 = time.perf_counter()
        tsim = TMS.MultiRobotSim(tcfg, None, beams=120, seed=seed,
                                 n_loops=2, width=16.0, height=10.0,
                                 device="cpu", trajectories=jsim.trajs)
        tsim.run(max_ticks=args.ticks)
        t2 = time.perf_counter()
        for name, sim, chi2 in (("jax", jsim, jchi2), ("torch", tsim,
                                                       tchi2)):
            hs = [host(st) for st in sim.states]
            row[name] = []
            for r in range(2):
                out = robot_outcome(hs[r], hs[1 - r], sim.kf_gt[r])
                out["chi2"] = float(chi2(sim.states[r].slam.graph))
                row[name].append(out)
                print(f"seed {seed} {name:5s} robot {r}: chi2 "
                      f"{out['chi2']:.2f}, ATE {out['ate']:.4f} m, "
                      f"{out['inter_closures']} inter-robot closures, "
                      f"{out['star_edges']} star edges, agreement median "
                      f"{out['agree_median']} m, max {out['agree_max']} m",
                      flush=True)
        row["seconds"] = {"jax": t1 - t0, "torch": t2 - t1}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
