"""Where a keyframe's time goes in the PyTorch/CUDA port, on one GPU.

    python3 tools/profile_torch_keyframe.py [--keyframes N] [--window W]
                                            [--out PATH]

Runs the ``srslam`` default deployment (the one ``chip_smoke.py`` drives)
through ``SingleRobotSlam`` on the card for N keyframes and traces the
last W of them with ``torch.profiler``: host wall time per keyframe,
device busy time (sum of kernel durations; one stream, so kernels do not
overlap), the device's idle share, kernel launches per keyframe, and the
top operators by device time and by host time. Writes the full table to
``--out`` (default ``build/profiles/profile_torch_keyframe_<N>.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as C  # noqa: E402  (the deployment chip_smoke drives)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--keyframes", type=int, default=300)
    ap.add_argument("--window", type=int, default=30)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from cg_mrslam_tpu_torch.pipeline.slam import SingleRobotSlam

    print(C.card_line(), flush=True)
    cfg, traj, fov = C.srslam_setup()
    slam = SingleRobotSlam(cfg, traj.ranges.shape[1], traj.gt[0],
                           traj.ranges[0], fov=fov, max_range=10.0)
    t = 1

    def advance(n):
        nonlocal t
        done = 0
        while done < n and t < len(traj.gt):
            if slam.observe(traj.rel_odom[t - 1], traj.ranges[t]):
                done += 1
            t += 1
        torch.cuda.synchronize()
        return done

    advance(a.keyframes - a.window)
    bucket = slam.runner.bucket(slam.state)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = advance(a.window)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3    # ms
    rows = []
    for e in prof.key_averages():
        rows.append({"name": e.key, "count": e.count,
                     "device_ms": e.self_device_time_total / 1e3,
                     "host_ms": e.self_cpu_time_total / 1e3})
    by_dev = sorted(rows, key=lambda r: -r["device_ms"])[:15]
    by_host = sorted(rows, key=lambda r: -r["host_ms"])[:15]
    out = {
        "card": C.card_line(), "keyframes": n,
        "bucket_at_start": bucket,
        "wall_ms_per_keyframe": wall * 1e3 / n,
        "device_busy_ms_per_keyframe": busy / n,
        "device_idle_share": 1.0 - busy / (wall * 1e3),
        "kernel_launches_per_keyframe": len(kernels) / n,
        "top_device": by_dev, "top_host": by_host, "all": rows,
    }
    path = a.out or os.path.join(
        "build", "profiles", f"profile_torch_keyframe_{a.keyframes}.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "all"},
                     indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
