"""Two port robot nodes (``cg_mrslam_tpu_torch/mr/node.py``) over the real
native UDP transport on localhost, on the CPU: the assertions of the
reference's ``tests/test_udp_transport.py:test_two_nodes_over_udp`` (each
node hears the other, decodes everything, instantiates the peer's vertices;
a condensed star is spliced; the ping log round-trips for a bag replay).
``run_udp`` is the schedule both UDP files share.
"""

import time

import numpy as np
import torch

from cg_mrslam_tpu_torch.mr.node import RobotNode
from cg_mrslam_tpu_torch.mr.transport import UdpTransport
from test_torch_node import CFG, FOV, _trajs
from torch_port_helpers import free_base_port, npy

torch.set_num_threads(1)


def run_udp(nodes, trajs, T, second_round_dt):
    for t in range(1, T):
        any_kf = False
        for r, node in enumerate(nodes):
            kf = node.observe(trajs[r].rel_odom[t - 1], trajs[r].ranges[t],
                              gt_pose=trajs[r].gt[t])
            any_kf = any_kf or kf
        if any_kf:
            for node in nodes:
                node.comm_round(0.1 * t)
            time.sleep(0.05)              # let the datagrams land
            for node in nodes:
                node.comm_round(0.1 * t + second_round_dt)


def test_two_port_nodes_over_udp(tmp_path):
    """``test_two_nodes_over_udp``'s assertions on the port."""
    trajs = _trajs()
    base = free_base_port(2)
    nodes = [RobotNode(CFG, r, 120, trajs[r].gt[0], trajs[r].ranges[0], FOV,
                       8.0, UdpTransport(r, 2, base_port=base),
                       modality="real", gt_pose=trajs[r].gt[0],
                       device="cpu") for r in range(2)]
    try:
        run_udp(nodes, trajs, min(260, min(len(t.gt) for t in trajs)),
                 0.05)
        for node in nodes:
            assert node.transport.native
            assert node.stats["received"] > 0, node.stats
            assert node.stats["decode_errors"] == 0, node.stats
        for r, node in enumerate(nodes):
            vo = npy(node.state.slam.v_owner)[npy(node.state.slam.graph.vmask)]
            assert (vo == 1 - r).sum() > 0, (r, vo.tolist())
        lvls = [npy(n.state.slam.graph.e_level)[npy(n.state.slam.graph.emask)]
                for n in nodes]
        assert (lvls[0] == 2).sum() + (lvls[1] == 1).sum() > 0
        p = str(tmp_path / "pings.jsonl")
        nodes[0].save_pings(p)
        assert (tmp_path / "pings.jsonl").stat().st_size > 0
        nodes[0].load_pings(p)
        assert nodes[0]._bag_events
        nodes[0].bag_tick(1e9)
        assert np.isfinite(nodes[0]._ping_time[1])
    finally:
        for node in nodes:
            node.close()
