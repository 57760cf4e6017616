"""The port's command line (``cg_mrslam_tpu_torch/cli.py``) against the
reference's (``cg_mrslam_tpu/cli.py``): ``srslam`` on the synthetic world at
a small scale, through each package's ``main`` (the port's with
``device="cpu"``), each in its own directory.

Bars (the whole-replay bars of ``tests/test_torch_pipeline.py``, and why):

* the same files are written: ``robot-0-<o>.g2o``, its map ``.pgm/.yaml``
  and the metrics JSONL;
* the graphs have equal ids (so equal keyframe counts), and every pose up
  to the first keyframe that accepts a loop closure agrees within 1e-3 m /
  rad: odometry chains solve to the same answer up to float32 noise;
* ATE within ±0.02 m and the printed closures within ±1: after a closure
  a near tie can move one match by one lattice step;
* the maps agree on ≥ 99% of their cells (the poses differ by float32
  noise, and boundary cells of a ray can move with them).

Also: ``cg_mrslam --idRobot 0`` (the per-process UDP deployment, not
ported) raises ``NotImplementedError``; the bag modality without a ping log
is refused.
"""

import os

import numpy as np
import pytest
import torch

from cg_mrslam_tpu import cli as jcli
from cg_mrslam_tpu.pipeline.slam import SingleRobotSlam as JSlam
from cg_mrslam_tpu.sim import world as JW
from cg_mrslam_tpu_torch import cli as tcli
from cg_mrslam_tpu_torch.pipeline.slam import SingleRobotSlam as TSlam

from torch_port_helpers import (ate, compare_graph_files, compare_maps,
                                keyframe_lines, run_cli)

torch.set_num_threads(1)

SMALL = ["--ticks", "150", "--beams", "90", "--max-vertices", "64",
         "--max-edges", "256", "--world-width", "16", "--world-height", "10",
         "--max-range", "8", "--resolution", "0.05"]


def _gt():
    """The ground truth the srslam command drives (seed 0 + 1, route 0)."""
    traj = JW.simulate_robot(
        JW.hospital_world(16.0, 10.0, seed=0),
        JW.corridor_waypoints(16.0, 10.0, 0, 2), seed=1, beams=8,
        fov=2 * np.pi * 0.75, max_range=8.0, odom_noise=(0.01, 0.004))
    return traj.gt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, main, cls, kw in (("ref", jcli.main, JSlam, {}),
                                ("port", tcli.main, TSlam,
                                 {"device": "cpu"})):
        d = tmp_path_factory.mktemp(name)
        with pytest.MonkeyPatch.context() as mp:
            stdout, ticks = run_cli(main, ["srslam", "-o", "s"] + SMALL, d,
                                    mp, slam_cls=cls, **kw)
        out[name] = (d, stdout, ticks)
    return out


def test_srslam_writes_the_references_outputs(runs):
    (rd, rout, rticks), (pd, pout, pticks) = runs["ref"], runs["port"]
    names = sorted(os.listdir(rd))
    assert names == ["robot-0-s-map.pgm", "robot-0-s-map.yaml",
                     "robot-0-s-metrics.jsonl", "robot-0-s.g2o"]
    assert sorted(os.listdir(pd)) == names
    rk, pk = keyframe_lines(rout), keyframe_lines(pout)
    assert len(rk) == len(pk) >= 20
    closed = [k for k, (_, c) in enumerate(rk) if c > 0]
    # slot k + 1 holds keyframe k (slot 0 is the first pose)
    first = closed[0] + 1 if closed else None
    pr, pp = compare_graph_files(rd / "robot-0-s.g2o", pd / "robot-0-s.g2o",
                                 first)
    assert abs(sum(c for _, c in rk) - sum(c for _, c in pk)) <= 1
    gt = _gt()
    # the same keyframe ticks, at least up to the first closure
    k = closed[0] if closed else len(rticks)
    assert rticks[:k] == pticks[:k]
    a_ref = ate(pr, gt[[0] + rticks])
    a_port = ate(pp, gt[[0] + pticks])
    assert abs(a_ref - a_port) <= 0.02, (a_ref, a_port)
    compare_maps(rd / "robot-0-s-map.pgm", pd / "robot-0-s-map.pgm")
    assert (rd / "robot-0-s-map.yaml").read_text().split("origin")[0] == \
        (pd / "robot-0-s-map.yaml").read_text().split("origin")[0]
    assert (pd / "robot-0-s-metrics.jsonl").stat().st_size > 0


def test_idrobot_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcli.main(["cg_mrslam", "--idRobot", "0"] + SMALL, device="cpu")
    assert tcli.main(["--help"]) == 0
    assert tcli.main(["nonsense"]) == 2
    assert tcli.main(["cg_mrslam", "--modality", "bag"], device="cpu") == 2
