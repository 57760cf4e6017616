"""List the host synchronizations of the port's keyframe step on one GPU.

    python3 tools/find_torch_syncs.py [--keyframes N]
    python3 tools/find_torch_syncs.py --node [--ticks T] [--gate]

Runs the ``srslam`` default deployment (``chip_smoke.py``'s) on the card
for N keyframes with ``torch.cuda.set_sync_debug_mode("warn")`` on for the
last one, and prints each source line that made a synchronizing CUDA call
with its count. A keyframe should have two: the host-to-device copy of its
inputs and the one device-to-host copy of its packed ``StepInfo``.

With ``--node``: two robot nodes of the per-process deployment
(``mr/node.py``, ``chip_smoke.py`` phase 10's configuration) in this
process over the native UDP transport on localhost, driven T ticks; then
the syncs of robot 0's next keyframe tick are counted apart for
``observe`` (the keyframe step, the global search and the vote) and for
``comm_round`` (decode, receive, search, build and encode), and for the
next tick without a keyframe. ``--gate`` turns on the visibility gate of
the global search (``MRConfig.detect_robot_in_range``), which should add
no synchronization.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import warnings

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as C  # noqa: E402  (the deployment chip_smoke drives)


def count_syncs(fn):
    """Run ``fn`` with the sync debug mode on; returns its result and the
    synchronizing calls by source line."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "called a synchronizing" in str(w.message))


def report(title, where) -> None:
    print(f"{sum(where.values())} synchronizing calls in {title}")
    for loc, n in where.most_common():
        print(f"{n:4d}  {loc}")


def node_syncs(ticks: int, gate: bool = False) -> int:
    import dataclasses

    import numpy as np

    from cg_mrslam_tpu_torch.mr.node import RobotNode
    from cg_mrslam_tpu_torch.mr.transport import UdpTransport
    from cg_mrslam_tpu_torch.sim import world as W

    cfg = C.deployment_config(2)
    cfg = dataclasses.replace(cfg, mr=dataclasses.replace(
        cfg.mr, detect_robot_in_range=gate))
    world = W.hospital_world(40.0, 20.0, seed=0)
    fov = 2 * np.pi * 0.75
    trajs = [W.simulate_robot(world, W.corridor_waypoints(40.0, 20.0, r, 2),
                              seed=7 * r, beams=360, fov=fov, max_range=10.0,
                              odom_noise=(0.01, 0.004)) for r in range(2)]
    base = C.free_base_port(2)
    nodes = [RobotNode(cfg, r, 360, trajs[r].gt[0], trajs[r].ranges[0], fov,
                       10.0, UdpTransport(r, 2, base_port=base),
                       modality="sim", gt_pose=trajs[r].gt[0])
             for r in range(2)]

    def tick(t, which=(0, 1)):
        kf = False
        for r in which:
            n = nodes[r]
            kf |= n.observe(trajs[r].rel_odom[t - 1], trajs[r].ranges[t],
                            gt_pose=trajs[r].gt[t])
            n.comm_round(0.1 * t)
        return kf

    try:
        for t in range(1, ticks):
            tick(t)
        t = ticks
        found = {}
        while len(found) < 2:
            tick(t, (1,))
            n, r = nodes[0], 0
            kf, obs = count_syncs(lambda: n.observe(
                trajs[r].rel_odom[t - 1], trajs[r].ranges[t],
                gt_pose=trajs[r].gt[t]))
            _, comm = count_syncs(lambda: n.comm_round(0.1 * t))
            key = "keyframe" if kf else "no keyframe"
            if key not in found:
                found[key] = (t, obs, comm)
            t += 1
        print(f"robot 0 after {ticks} ticks: {nodes[0].stats}")
        for key, (t, obs, comm) in sorted(found.items()):
            report(f"robot 0's observe at tick {t} ({key})", obs)
            report(f"robot 0's comm_round at tick {t} ({key})", comm)
    finally:
        for n in nodes:
            n.close()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--keyframes", type=int, default=20)
    ap.add_argument("--node", action="store_true")
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--gate", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    if a.node:
        return node_syncs(a.ticks, a.gate)
    from cg_mrslam_tpu_torch.pipeline.slam import SingleRobotSlam

    cfg, traj, fov = C.srslam_setup()
    slam = SingleRobotSlam(cfg, traj.ranges.shape[1], traj.gt[0],
                           traj.ranges[0], fov=fov, max_range=10.0)
    t = 1
    while len(slam.infos) < a.keyframes - 1:
        slam.observe(traj.rel_odom[t - 1], traj.ranges[t])
        t += 1
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        while len(slam.infos) < a.keyframes:
            slam.observe(traj.rel_odom[t - 1], traj.ranges[t])
            t += 1
        torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "called a synchronizing" in str(w.message))
    print(f"{sum(where.values())} synchronizing calls in one keyframe")
    for loc, n in where.most_common():
        print(f"{n:4d}  {loc}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
