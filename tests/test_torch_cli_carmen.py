"""``srslam --carmen`` (replay of a CARMEN log) in the port's command line
against the reference's, at the small scale of ``tests/test_torch_cli.py``.

The log holds the synthetic route's first 150 ticks (noisy odometry, exact
scans), written by the port's ``carmen.write``; both packages replay it.
Bars as in ``test_torch_cli.py``: the same files, equal ids, poses within
1e-3 m / rad up to the first keyframe that accepts a closure, ATE against
the route's ground truth within ±0.02 m, printed closures within ±1, maps
equal on ≥ 99% of their cells.
"""

import os

import numpy as np
import torch

from cg_mrslam_tpu import cli as jcli
from cg_mrslam_tpu.pipeline.slam import SingleRobotSlam as JSlam
from cg_mrslam_tpu.sim import world as JW
from cg_mrslam_tpu_torch import cli as tcli
from cg_mrslam_tpu_torch.io import carmen
from cg_mrslam_tpu_torch.pipeline.slam import SingleRobotSlam as TSlam

from torch_port_helpers import (ate, compare_graph_files, compare_maps,
                                keyframe_lines, run_cli)

torch.set_num_threads(1)

FOV = 2 * np.pi * 0.75
SMALL = ["--beams", "90", "--max-vertices", "64", "--max-edges", "256",
         "--max-range", "8", "--resolution", "0.05"]


def test_srslam_carmen_matches_the_reference(tmp_path, monkeypatch):
    traj = JW.simulate_robot(
        JW.hospital_world(16.0, 10.0, seed=0),
        JW.corridor_waypoints(16.0, 10.0, 0, 2), seed=1, beams=90, fov=FOV,
        max_range=8.0, odom_noise=(0.01, 0.004))
    log = str(tmp_path / "route.clf")
    carmen.write(log, traj.odom[:150], traj.ranges[:150], fov=FOV,
                 max_range=8.0, start_angle=-FOV / 2, angular_step=FOV / 90)
    out = {}
    for name, main, cls, kw in (("ref", jcli.main, JSlam, {}),
                                ("port", tcli.main, TSlam,
                                 {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        stdout, ticks = run_cli(main, ["srslam", "-o", "c", "--carmen", log]
                                + SMALL, d, monkeypatch, slam_cls=cls, **kw)
        out[name] = (d, keyframe_lines(stdout), ticks)
    (rd, rk, rt), (pd, pk, pt) = out["ref"], out["port"]
    assert sorted(os.listdir(pd)) == sorted(os.listdir(rd))
    assert len(rk) == len(pk) >= 10
    closed = [k for k, (_, c) in enumerate(rk) if c > 0]
    k = closed[0] if closed else len(rt)
    assert rt[:k] == pt[:k]
    pr, pp = compare_graph_files(rd / "robot-0-c.g2o", pd / "robot-0-c.g2o",
                                 k + 1 if closed else None)
    assert abs(sum(c for _, c in rk) - sum(c for _, c in pk)) <= 1
    a_ref, a_port = ate(pr, traj.gt[[0] + rt]), ate(pp, traj.gt[[0] + pt])
    assert abs(a_ref - a_port) <= 0.02, (a_ref, a_port)
    compare_maps(rd / "robot-0-c-map.pgm", pd / "robot-0-c-map.pgm")
