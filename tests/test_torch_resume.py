"""Checkpoint and resume in the port (``pipeline/slam.py:state_from_g2o``,
``SingleRobotSlam.resume``) against the reference: the case of
``tests/test_resume.py:27-70`` (save mid-run, reload, keep keyframing).

The port runs the first 120 ticks and saves; both packages resume from that
file and feed the next 120 ticks. Bars and why:

* the reloaded state equals the saved one: vertex count, scans, poses
  within 1e-5 m / rad (the file holds 6 decimals);
* the reference's own checks hold on the port: keyframes append, poses
  stay finite, the last estimate within 1 m of the ground truth;
* the two packages' reloaded states are equal, and their continued runs
  agree as the whole-replay bars of ``tests/test_torch_pipeline.py`` say:
  poses within 1e-3 m / rad up to the first keyframe that accepts a
  closure, closures within ±1.
"""

import numpy as np
import torch

from cg_mrslam_tpu.config import Config as JConfig
from cg_mrslam_tpu.config import MatcherConfig as JMatcher
from cg_mrslam_tpu.config import SlamConfig as JSlamCfg
from cg_mrslam_tpu.pipeline.slam import SingleRobotSlam as JSlam
from cg_mrslam_tpu.sim import world as JW
from cg_mrslam_tpu_torch.config import Config, MatcherConfig, SlamConfig
from cg_mrslam_tpu_torch.io import g2o
from cg_mrslam_tpu_torch.pipeline.slam import SingleRobotSlam

from torch_port_helpers import npy

torch.set_num_threads(1)

KW = dict(close_matcher=dict(extent=16.0, resolution=0.05,
                             kernel_radius=0.2),
          lc_matcher=dict(extent=24.0, resolution=0.1, kernel_radius=0.5),
          max_vertices=128, max_edges=512)
CUT = 120


def _cfg(config, matcher, slam_cfg):
    return config(slam=slam_cfg(min_inliers=4, window_loop_closure=8),
                  close_matcher=matcher(**KW["close_matcher"]),
                  lc_matcher=matcher(**KW["lc_matcher"]),
                  max_vertices=KW["max_vertices"],
                  max_edges=KW["max_edges"])


def test_save_resume_continue_matches_the_reference(tmp_path):
    cfg = _cfg(Config, MatcherConfig, SlamConfig)
    traj = JW.simulate_robot(JW.hospital_world(width=16.0, height=10.0,
                                               seed=2),
                             JW.corridor_waypoints(16.0, 10.0, 0, 1), seed=5,
                             beams=120, max_range=8.0)
    fov = 2 * np.pi * 0.75
    slam = SingleRobotSlam(cfg, 120, traj.gt[0], traj.ranges[0], fov, 8.0,
                           device="cpu")
    for t in range(1, CUT):
        slam.observe(traj.rel_odom[t - 1], traj.ranges[t])
    n_before = int(slam.state.graph.n_vertices)
    assert n_before > 10
    path = str(tmp_path / "ckpt.g2o")
    ids = (npy(slam.state.v_remote).astype(np.int64)
           + npy(slam.state.v_owner) * cfg.slam.base_id)
    g2o.save(path, slam.state.graph, ids=ids, scans=slam.state.scans)

    port = SingleRobotSlam.resume(cfg, path, device="cpu")
    ref = JSlam.resume(_cfg(JConfig, JMatcher, JSlamCfg), path)
    assert int(port.state.graph.n_vertices) == n_before
    np.testing.assert_allclose(npy(port.state.graph.poses)[:n_before],
                               npy(slam.state.graph.poses)[:n_before],
                               atol=1e-5)
    assert int(npy(port.state.scans.smask).sum()) == n_before
    for name in ("poses", "vmask", "fixed", "e_ij", "emask", "e_owner",
                 "e_level"):
        np.testing.assert_array_equal(npy(getattr(port.state.graph, name)),
                                      npy(getattr(ref.state.graph, name)))
    for name in ("v_owner", "v_remote"):
        np.testing.assert_array_equal(npy(getattr(port.state, name)),
                                      npy(getattr(ref.state, name)))
    np.testing.assert_array_equal(port._est, ref._est)

    end = min(CUT + 120, len(traj.gt))
    for t in range(CUT, end):
        port.observe(traj.rel_odom[t - 1], traj.ranges[t])
        ref.observe(traj.rel_odom[t - 1], traj.ranges[t])
    n_after = int(port.state.graph.n_vertices)
    assert n_after == int(ref.state.graph.n_vertices) > n_before
    p = npy(port.state.graph.poses)[npy(port.state.graph.vmask)]
    assert np.isfinite(p).all()
    err = np.asarray(port.infos[-1].pose)[:2] - traj.gt[end - 1][:2]
    assert np.hypot(*err) < 1.0, err
    closed = [k for k, i in enumerate(ref.infos) if i.closures_added]
    k = n_before + (closed[0] if closed else len(ref.infos))
    d = npy(port.state.graph.poses)[:k] - npy(ref.state.graph.poses)[:k]
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(d).max() <= 1e-3, np.abs(d).max()
    assert abs(sum(i.closures_added for i in port.infos)
               - sum(i.closures_added for i in ref.infos)) <= 1
