"""Parity of the port's visualization export (``maps/viz.py``) with
``cg_mrslam_tpu.maps.viz``, on the state of ``tests/test_viz_network.py::
test_viz_exports``'s run (the reference's ``SingleRobotSlam``, 120 ticks)
carried across with ``convert.py``.

Bars and why: the trajectory is a copy of the poses, so it is equal; the
laser points within 1e-5 m (the reference rotates the scans with XLA's
float32 ``sin``/``cos``, the port with ones rounded from float64, one
float32 step apart at most); ``map_to_odom`` within 1e-5 (one float32
composition); the PGM's header equal and at most 0.1% of its pixels
different (a pixel differs only where a point sits on a pixel edge).
"""

import numpy as np
import pytest
import torch

from cg_mrslam_tpu.maps import viz as JV
from cg_mrslam_tpu.pipeline.slam import SingleRobotSlam
from cg_mrslam_tpu.sim import world as JW
from cg_mrslam_tpu_torch import convert
from cg_mrslam_tpu_torch.maps import viz as TV
from test_viz_network import _small_cfg
from torch_port_helpers import CPU

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def states():
    world = JW.hospital_world(width=16.0, height=10.0, seed=2)
    wps = JW.corridor_waypoints(16.0, 10.0, 0, 1)
    traj = JW.simulate_robot(world, wps, seed=5, beams=120, max_range=8.0)
    slam = SingleRobotSlam(_small_cfg(), 120, traj.gt[0], traj.ranges[0],
                           2 * np.pi * 0.75, 8.0)
    for t in range(1, 120):
        slam.observe(traj.rel_odom[t - 1], traj.ranges[t])
    tstate = convert.state_from_numpy(convert.state_to_numpy(slam.state),
                                      CPU)
    return slam.state, tstate


def test_trajectory_and_points(states):
    jst, tst = states
    for own in (True, False):
        np.testing.assert_array_equal(TV.trajectory(tst, own_only=own),
                                      np.asarray(JV.trajectory(jst, own)))
    assert len(TV.trajectory(tst)) == int(tst.graph.n_vertices) > 10
    for stride in (10, 1):
        got = TV.laser_map_points(tst, stride=stride)
        want = JV.laser_map_points(jst, stride=stride)
        assert got.shape == want.shape and got.shape[0] > 50
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_map_to_odom(states):
    jst, tst = states
    tr = TV.trajectory(tst)
    np.testing.assert_allclose(TV.map_to_odom(tr[-1], tr[-1], device="cpu"),
                               [0, 0, 0], atol=1e-5)
    odom = tr[-1] + np.asarray([0.4, -0.3, 0.2], np.float32)
    np.testing.assert_allclose(TV.map_to_odom(tr[-1], odom, device="cpu"),
                               np.asarray(JV.map_to_odom(tr[-1], odom)),
                               rtol=0, atol=1e-5)


def test_map_to_odom_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TV.map_to_odom(np.zeros(3), np.zeros(3))


def test_render_png(states, tmp_path):
    jst, tst = states
    JV.render_png(str(tmp_path / "ref.pgm"), jst)
    TV.render_png(str(tmp_path / "port.pgm"), tst)
    a = (tmp_path / "ref.pgm").read_bytes()
    b = (tmp_path / "port.pgm").read_bytes()
    ha, hb = a.split(b"255\n", 1), b.split(b"255\n", 1)
    assert ha[0] == hb[0] and ha[0].startswith(b"P5\n")
    ia, ib = (np.frombuffer(h[1], np.uint8) for h in (ha, hb))
    assert ia.shape == ib.shape
    assert (ia != ib).mean() <= 1e-3, (ia != ib).mean()
    assert (ib == 160).sum() > 50 and (ib == 0).sum() > 9
