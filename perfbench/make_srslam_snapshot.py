"""Snapshot the graph of the program's single-robot hospital run.

    python3 perfbench/make_srslam_snapshot.py --out <file.npz>

Runs ``srslam`` as the program's command line runs it with its default
flags (the 40 x 20 m hospital world of seed 0, two loops of the corridor
route, 360 beams, 10 m range, odometry noise 0.01 m and 0.004 rad, the
keyframe gate of 0.25 m and π/4), at a capacity of 1024 vertices and 4096
edges, on the card, until the route ends. Saves robot 0's graph (the
``PoseGraph`` fields) as the scan matcher and the closures left it after
the last keyframe's ``optimize(5)``. The configuration
``hospital_1robot_cap1024`` tiles it (``perfbench/gen/hospital.py``);
``perfbench/data/srslam_hospital_1024.npz`` is the committed copy. The
benchmark's runs never run this script.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FIELDS = ("poses", "vmask", "fixed", "e_ij", "e_z", "e_info", "emask",
          "e_level", "e_owner", "n_vertices", "n_edges")


def main() -> int:
    ap = argparse.ArgumentParser(prog="perfbench/make_srslam_snapshot.py")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    from cg_mrslam_tpu_torch import cli
    from cg_mrslam_tpu_torch.pipeline.slam import SingleRobotSlam
    from cg_mrslam_tpu_torch.sim import world as W

    p = argparse.ArgumentParser()
    cli._common_flags(p)
    a = p.parse_args(["--max-vertices", "1024", "--max-edges", "4096"])
    cfg = cli._build_config(a)
    world = W.hospital_world(a.world_width, a.world_height, seed=a.seed)
    wps = W.corridor_waypoints(a.world_width, a.world_height, 0, a.loops)
    fov = 2 * np.pi * 0.75
    traj = W.simulate_robot(world, wps, seed=a.seed + 1, beams=a.beams,
                            fov=fov, max_range=a.max_range,
                            odom_noise=tuple(a.odom_noise))
    slam = SingleRobotSlam(cfg, a.beams, traj.gt[0], traj.ranges[0],
                           fov=fov, max_range=a.max_range)
    for t in range(1, len(traj.ranges)):
        slam.observe(traj.rel_odom[t - 1], traj.ranges[t])
        if slam.runner.n_live >= cfg.max_vertices - 2:
            break
    g = slam.state.graph
    snap = {k: getattr(g, k).cpu().numpy() for k in FIELDS}
    nv, ne = int(snap["n_vertices"]), int(snap["n_edges"])
    e = snap["e_ij"][snap["emask"]]
    closures = int(np.sum(e[:, 1] != e[:, 0] + 1))
    np.savez_compressed(args.out, **snap)
    print(f"keyframes {len(slam.infos)}, live vertices {nv}, live edges "
          f"{ne}, edges that join no consecutive vertices {closures}, "
          f"fixed {np.flatnonzero(snap['fixed']).tolist()}, last chi2 "
          f"{slam.infos[-1].chi2:.6f}; wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
