"""The port's per-process robot node (``cg_mrslam_tpu_torch/mr/node.py``)
against ``cg_mrslam_tpu/mr/node.py``, on the CPU.

(a) **Parity.** Two reference nodes and two port nodes, each pair over an
    in-memory loopback network (``torch_port_helpers.Loopback``: immediate,
    in-order delivery, so the same sends give the same receives), on the
    schedule and config of ``tests/test_udp_transport.py:105-174``
    (``test_two_nodes_over_udp``) and the reference simulator's scans. Bars
    and why: until the first accepted inter-robot closure every round's
    ``stats`` dicts are equal (the same datagrams were sent and received),
    the vertex slots, owners and remote indices are equal (integers) and the
    own keyframe poses agree within 1e-3 m / rad (float32 solves, the bar of
    ``tests/test_torch_pipeline.py``); after it the ATE of the own keyframes
    agrees within ±0.02 m and the inter-robot closures and star edges within
    ±1 (the scaled replay's bars in ``tests/test_torch_mr.py``: a closure
    accepted on a float32 near-tie by one side adds one boundary vertex).
(d) Bucketed stepping and the capacity counter
    (``tests/test_udp_transport.py:238-280``).

(b) and (c), the nodes over the real native transport, are in
``test_torch_node_udp.py`` and ``test_torch_node_beams.py`` (each ~2 min on
one CPU worker; separate files run on separate workers).
"""

import dataclasses

import numpy as np
import torch

from cg_mrslam_tpu.config import Config as JConfig
from cg_mrslam_tpu.config import MatcherConfig as JMatcher
from cg_mrslam_tpu.config import MRConfig as JMRConfig
from cg_mrslam_tpu.config import SlamConfig as JSlamCfg
from cg_mrslam_tpu.mr.node import RobotNode as JNode
from cg_mrslam_tpu.sim import world as JW
from cg_mrslam_tpu_torch.config import (Config, MatcherConfig, MRConfig,
                                        SlamConfig)
from cg_mrslam_tpu_torch.mr.node import RobotNode
from cg_mrslam_tpu_torch.mr.transport import UdpTransport
from torch_port_helpers import Loopback, ate, free_base_port, npy

torch.set_num_threads(1)

FOV = 2 * np.pi * 0.75


def _cfg(config, slam, mr, matcher):
    """``tests/test_udp_transport.py``'s ``CFG`` in either package."""
    return config(
        slam=slam(min_inliers=4, window_loop_closure=8),
        mr=mr(n_robots=2, min_inliers_mr=4, sim_comm_range=6.0,
              max_score_mr=0.2),
        close_matcher=matcher(extent=16.0, resolution=0.05,
                              kernel_radius=0.2),
        lc_matcher=matcher(extent=24.0, resolution=0.1, kernel_radius=0.5),
        max_vertices=96, max_edges=512)


JCFG = _cfg(JConfig, JSlamCfg, JMRConfig, JMatcher)
CFG = _cfg(Config, SlamConfig, MRConfig, MatcherConfig)


def _trajs(beams=(120, 120), loops=2):
    world = JW.hospital_world(width=16.0, height=10.0, seed=2)
    return [JW.simulate_robot(world, JW.corridor_waypoints(16.0, 10.0, r,
                                                           loops),
                              seed=11 + 7 * r, beams=beams[r], fov=FOV,
                              max_range=8.0, odom_noise=(0.02, 0.008))
            for r in range(2)]


def _own_poses(node) -> np.ndarray:
    st = node.state.slam
    vm, vo, vr = npy(st.graph.vmask), npy(st.v_owner), npy(st.v_remote)
    own = np.flatnonzero(vm & (vo == node.id))
    return npy(st.graph.poses)[own[np.argsort(vr[own])]]


def _outcomes(node):
    """(inter-robot closures, star edges) of a node's graph."""
    g = node.state.slam.graph
    em = npy(g.emask)
    ij, lvl = npy(g.e_ij)[em], npy(g.e_level)[em]
    vo = npy(node.state.slam.v_owner)
    return (int(((vo[ij[:, 0]] != vo[ij[:, 1]]) & (lvl == 0)).sum()),
            int((lvl > 0).sum()))


def _accepted(node) -> bool:
    return bool(npy(node.state.out_closures).any())


def test_loopback_parity_with_reference():
    trajs = _trajs()
    nets = {"ref": Loopback(2), "port": Loopback(2)}
    nodes = {
        "ref": [JNode(JCFG, r, 120, trajs[r].gt[0], trajs[r].ranges[0], FOV,
                      8.0, nets["ref"].endpoint(r), modality="real",
                      gt_pose=trajs[r].gt[0]) for r in range(2)],
        "port": [RobotNode(CFG, r, 120, trajs[r].gt[0], trajs[r].ranges[0],
                           FOV, 8.0, nets["port"].endpoint(r),
                           modality="real", gt_pose=trajs[r].gt[0],
                           device="cpu") for r in range(2)]}
    kf_ticks = {k: [[0], [0]] for k in nodes}
    T = min(260, min(len(t.gt) for t in trajs))
    exact, rounds = True, 0
    for t in range(1, T):
        kfs = {}
        for k, pair in nodes.items():
            kfs[k] = [n.observe(trajs[r].rel_odom[t - 1], trajs[r].ranges[t],
                                gt_pose=trajs[r].gt[t])
                      for r, n in enumerate(pair)]
            for r, kf in enumerate(kfs[k]):
                if kf:
                    kf_ticks[k][r].append(t)
        if exact and any(_accepted(n) for pair in nodes.values()
                         for n in pair):
            exact = False           # the first accepted closure: from here
            first = t               # on, outcomes are judged
        if exact:
            assert kfs["ref"] == kfs["port"], (t, kfs)
        for k, pair in nodes.items():
            if any(kfs[k]):
                for n in pair:
                    n.comm_round(0.1 * t)
                for n in pair:
                    n.comm_round(0.1 * t + 0.05)
        if exact and any(kfs["port"]):
            rounds += 1
            for j, p in zip(nodes["ref"], nodes["port"]):
                assert p.stats == j.stats, (t, p.id, p.stats, j.stats)
                for f in ("v_owner", "v_remote"):
                    np.testing.assert_array_equal(
                        npy(getattr(p.state.slam, f)),
                        npy(getattr(j.state.slam, f)), err_msg=f"{t} {f}")
                np.testing.assert_array_equal(npy(p.state.slam.graph.vmask),
                                              npy(j.state.slam.graph.vmask))
                d = _own_poses(p) - _own_poses(j)
                d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
                assert np.abs(d).max() <= 1e-3, (t, p.id, np.abs(d).max())
    assert not exact and rounds >= 10, (exact, rounds)
    # the exchange happened before the first closure: foreign vertices
    assert first > 1
    for r in range(2):
        j, p = nodes["ref"][r], nodes["port"][r]
        a_ref = ate(_own_poses(j), trajs[r].gt[kf_ticks["ref"][r]])
        a_port = ate(_own_poses(p), trajs[r].gt[kf_ticks["port"][r]])
        assert abs(a_ref - a_port) <= 0.02, (r, a_ref, a_port)
        (ji, js), (pi, ps) = _outcomes(j), _outcomes(p)
        assert abs(ji - pi) <= 1 and abs(js - ps) <= 1, (r, (ji, js),
                                                         (pi, ps))
        assert p.stats["decode_errors"] == 0 and p.stats["received"] > 0


def test_node_bucketed_stepping_and_capacity_counter():
    """The node runs the bucketed step (a slice below the capacity serves
    the early run) and counts the keyframes refused at the capacity stop."""
    cfg = Config(
        slam=SlamConfig(), mr=MRConfig(n_robots=1),
        close_matcher=MatcherConfig(extent=8.0, resolution=0.1,
                                    kernel_radius=0.2),
        lc_matcher=MatcherConfig(extent=12.0, resolution=0.2,
                                 kernel_radius=0.5),
        max_vertices=300, max_edges=1200, max_beams=64)
    ranges = np.full((64,), 5.0, np.float32)
    base = free_base_port(1, slot=2)
    node = RobotNode(cfg, 0, 64, np.zeros(3), ranges, FOV, 8.0,
                     UdpTransport(0, 1, base_port=base), modality="real",
                     device="cpu")
    seen = []
    step = node.runner.step

    def spy(state, est, r):
        seen.append(node.runner.bucket(state))
        return step(state, est, r)

    node.runner.step = spy
    try:
        for _ in range(3):
            assert node.observe(np.asarray([0.3, 0.0, 0.0]), ranges)
        assert seen and all(nb < cfg.max_vertices for nb, _ in seen), seen
        cfg2 = dataclasses.replace(cfg, max_vertices=8, max_edges=64)
        node2 = RobotNode(cfg2, 0, 64, np.zeros(3), ranges, FOV, 8.0,
                          UdpTransport(0, 1, base_port=free_base_port(1, slot=3)),
                          modality="real", device="cpu")
        try:
            for _ in range(8):
                node2.observe(np.asarray([0.3, 0.0, 0.0]), ranges)
            assert node2.stats["keyframes_capacity_stopped"] > 0
            assert int(node2.state.slam.graph.n_vertices) \
                <= cfg2.max_vertices - 4
        finally:
            node2.close()
    finally:
        node.close()
