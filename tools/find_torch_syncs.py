"""List the host synchronizations of the port's keyframe step on one GPU.

    python3 tools/find_torch_syncs.py [--keyframes N]

Runs the ``srslam`` default deployment (``chip_smoke.py``'s) on the card
for N keyframes with ``torch.cuda.set_sync_debug_mode("warn")`` on for the
last one, and prints each source line that made a synchronizing CUDA call
with its count. A keyframe should have two: the host-to-device copy of its
inputs and the one device-to-host copy of its packed ``StepInfo``.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--keyframes", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
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
