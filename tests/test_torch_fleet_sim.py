"""Parity of the port's ``FleetSim`` (``parallel/fleet_sim.py``: one fleet
round per keyframing tick, one host read a round) with
``cg_mrslam_tpu.parallel.fleet_sim.FleetSim`` and with the port's host-loop
``MultiRobotSim``, on ``tests/test_fleet_sim.py``'s config over the same
scans (the reference simulator's), for ``TICKS`` ticks — enough for both
robots to hold foreign vertices and splice stars.

Bars, as ``tests/test_fleet_sim.py`` holds the reference's two drivers:
every discrete decision is equal (keyframes, vertex and edge counts, the
edge set with its levels, vertex ownership); the mean translation error of
each robot's own keyframes against ground truth agrees within 0.05 m
(a near-tied score volume can move a match by one lattice step on float32
noise), and each is under 0.5 m.
"""

import numpy as np
import pytest
import torch

from cg_mrslam_tpu.config import Config, MatcherConfig, MRConfig, SlamConfig
from cg_mrslam_tpu.parallel.fleet_sim import FleetSim as JFleetSim
from cg_mrslam_tpu.sim import world as JW
from cg_mrslam_tpu_torch import config as tconfig
from cg_mrslam_tpu_torch.mr import sim as TMS
from cg_mrslam_tpu_torch.parallel import fleet as TF
from cg_mrslam_tpu_torch.parallel.fleet_sim import FleetSim as TFleetSim
from torch_port_helpers import npy

torch.set_num_threads(1)

TICKS = 60
KW = dict(beams=120, seed=11, n_loops=2, width=16.0, height=10.0)


def _cfgs():
    """``tests/test_fleet_sim.py``'s config in both packages."""
    def build(m):
        return m.Config(
            slam=m.SlamConfig(min_inliers=4, window_loop_closure=8),
            mr=m.MRConfig(n_robots=2, min_inliers_mr=4, sim_comm_range=6.0,
                          max_score_mr=0.2),
            close_matcher=m.MatcherConfig(extent=16.0, resolution=0.05,
                                          kernel_radius=0.2),
            lc_matcher=m.MatcherConfig(extent=24.0, resolution=0.1,
                                       kernel_radius=0.5),
            max_vertices=96, max_edges=512)

    class Ref:
        Config, SlamConfig, MatcherConfig, MRConfig = (
            Config, SlamConfig, MatcherConfig, MRConfig)

    return build(Ref), build(tconfig)


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = _cfgs()
    jfs = JFleetSim(jcfg, JW.hospital_world(width=16.0, height=10.0,
                                            seed=2), **KW)
    jfs.run(max_ticks=TICKS)
    tfs = TFleetSim(tcfg, None, device="cpu", trajectories=jfs.trajs, **KW)
    tfs.run(max_ticks=TICKS)
    hs = TMS.MultiRobotSim(tcfg, None, device="cpu",
                           trajectories=jfs.trajs, **KW)
    hs.run(max_ticks=TICKS)
    return jfs, tfs, hs


def _ate(states, kf_gt, r):
    vo = npy(states.slam.v_owner[r])
    vm = npy(states.slam.graph.vmask[r])
    own = np.where((vo == r) & vm)[0]
    gt = np.asarray(kf_gt[r])
    p = npy(states.slam.graph.poses[r])[own]
    n = min(len(gt), len(p))
    return np.linalg.norm(p[:n, :2] - gt[:n, :2], axis=1).mean()


@pytest.mark.parametrize("other", ["reference FleetSim", "MultiRobotSim"])
def test_fleet_sim_matches(runs, other):
    jfs, tfs, hs = runs
    if other == "MultiRobotSim":
        ref, ref_kf = TF.stack_states(hs.states), hs.kf_gt
    else:
        ref, ref_kf = jfs.states, jfs.kf_gt
    got = tfs.states
    for r in range(2):
        assert len(tfs.kf_gt[r]) == len(ref_kf[r])
        assert int(got.slam.graph.n_vertices[r]) == int(
            npy(ref.slam.graph.n_vertices[r]))
        assert int(got.slam.graph.n_edges[r]) == int(
            npy(ref.slam.graph.n_edges[r]))
        em = npy(ref.slam.graph.emask[r])
        np.testing.assert_array_equal(npy(got.slam.graph.emask[r]), em)
        for f in ("e_ij", "e_level"):
            np.testing.assert_array_equal(
                npy(getattr(got.slam.graph, f)[r])[em],
                npy(getattr(ref.slam.graph, f)[r])[em], err_msg=f)
        np.testing.assert_array_equal(npy(got.slam.v_owner[r]),
                                      npy(ref.slam.v_owner[r]))
        ate_f = _ate(got, tfs.kf_gt, r)
        ate_h = _ate(ref, ref_kf, r)
        assert abs(ate_f - ate_h) < 0.05, (ate_f, ate_h)
        assert ate_f < 0.5 and ate_h < 0.5, (ate_f, ate_h)
    # the fused rounds found inter-robot structure: foreign vertices and
    # spliced stars on each robot
    owners = npy(got.slam.v_owner)
    vm = npy(got.slam.graph.vmask)
    lvl, em = npy(got.slam.graph.e_level), npy(got.slam.graph.emask)
    for r in range(2):
        assert ((owners[r] != r) & vm[r]).any()
        assert ((lvl[r] > 0) & em[r]).any()
    assert len(tfs.round_latencies) > 10
