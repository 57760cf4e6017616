"""Port robot nodes with different beam counts (120 and 180) over the real
native UDP transport, on the CPU: the case of the reference's
``tests/test_udp_transport.py:176-235``. A combo says its own beam geometry
and the receiver resamples the peer's scan onto its grid: the foreign scans
are finite, within the max range and of the receiver's beam count.
"""

import numpy as np
import torch

from cg_mrslam_tpu_torch.mr.node import RobotNode
from cg_mrslam_tpu_torch.mr.transport import UdpTransport
from test_torch_node import CFG, FOV, _trajs
from test_torch_node_udp import run_udp
from torch_port_helpers import free_base_port, npy

torch.set_num_threads(1)


def test_heterogeneous_beam_nodes_interop():
    """Nodes with 120 and 180 beams: the combo says its geometry and the
    receiver resamples it onto its own grid."""
    beams = (120, 180)
    trajs = _trajs(beams, loops=1)
    base = free_base_port(2, slot=1)
    nodes = [RobotNode(CFG, r, beams[r], trajs[r].gt[0], trajs[r].ranges[0],
                       FOV, 8.0, UdpTransport(r, 2, base_port=base),
                       modality="real", gt_pose=trajs[r].gt[0],
                       device="cpu") for r in range(2)]
    try:
        run_udp(nodes, trajs, min(160, min(len(t.gt) for t in trajs)),
                 0.16)
        for r, node in enumerate(nodes):
            assert node.stats["decode_errors"] == 0, node.stats
            st = node.state.slam
            foreign = (npy(st.graph.vmask) & (npy(st.v_owner) == 1 - r)
                       & npy(st.scans.smask))
            assert foreign.any(), r
            rr = npy(st.scans.ranges)[foreign]
            assert rr.shape[1] == beams[r]
            assert np.isfinite(rr).all() and (rr <= 8.0 + 1e-4).all()
    finally:
        for node in nodes:
            node.close()
