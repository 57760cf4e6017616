"""Parity of the port's sensor ingestion seam (``io/stream.py``) with
``cg_mrslam_tpu.io.stream``: the three cases of ``tests/test_stream.py``
through both packages.

Bars and why: ``SimSource``'s poses and odometry increments are the same
seeded numpy arithmetic, so equal; its scans are ray-cast in float32 by
both simulators and held to ``tests/test_torch_pipeline.py``'s scan bar
(1e-5 m but a bounded share of grazing hits, where XLA's fused
multiply-adds round differently). ``ReplaySource`` → ``run_slam_on_source``:
the same keyframe count, and poses within 1e-3 m / rad
(``test_torch_pipeline.py``'s bar before the first closure). The live UDP
source: increments equal bit for bit to the reference's float64
arithmetic, and ``TimeoutError`` when no data arrives.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from cg_mrslam_tpu.config import Config, MatcherConfig
from cg_mrslam_tpu.io import carmen as JC
from cg_mrslam_tpu.io import stream as JS
from cg_mrslam_tpu.sim import world as JW
from cg_mrslam_tpu_torch import config as tconfig
from cg_mrslam_tpu_torch.io import stream as TS
from torch_port_helpers import free_base_port

torch.set_num_threads(1)


def _cfgs():
    """``tests/test_stream.py``'s config in both packages."""
    def build(m):
        return m.Config(
            close_matcher=m.MatcherConfig(extent=16.0, resolution=0.05,
                                          kernel_radius=0.2),
            lc_matcher=m.MatcherConfig(extent=24.0, resolution=0.1,
                                       kernel_radius=0.5),
            max_vertices=32, max_edges=128)

    class Ref:
        Config, MatcherConfig = Config, MatcherConfig

    return build(Ref), build(tconfig)


def test_sim_source_contract():
    kw = dict(width=16.0, height=10.0, beams=90, max_range=8.0, loops=1,
              seed=3)
    jsrc = JS.SimSource(**kw)
    tsrc = TS.SimSource(**kw, device="cpu")
    (jg, jp, jr), (tg, tp, tr) = jsrc.open(), tsrc.open()
    assert tg == TS.SensorGeometry(**vars(jg))
    np.testing.assert_array_equal(tp, jp)
    pairs = list(zip(jsrc.read(), tsrc.read()))
    assert len(pairs) == len(jsrc._traj.rel_odom) > 100
    rels = [(a[0], b[0]) for a, b in pairs]
    np.testing.assert_array_equal([t for _, t in rels], [j for j, _ in rels])
    d = np.abs(np.stack([tr] + [b[1] for _, b in pairs]).astype(np.float64)
               - np.stack([jr] + [a[1] for a, _ in pairs]))
    assert tr.shape == (90,)
    assert np.mean(d > 1e-5) <= 1e-3, np.sort(d.ravel())[-10:]
    assert d.max() <= 5e-5, d.max()


def test_replay_source_runs_slam(tmp_path):
    world = JW.hospital_world(16.0, 10.0, seed=3)
    traj = JW.simulate_robot(
        world, JW.corridor_waypoints(16.0, 10.0, 0, 1), seed=4, beams=90,
        fov=2 * np.pi * 0.75, max_range=8.0)
    path = str(tmp_path / "log.clf")
    JC.write(path, traj.odom[:40], traj.ranges[:40],
             fov=2 * np.pi * 0.75, max_range=8.0,
             start_angle=-np.pi * 0.75, angular_step=2 * np.pi * 0.75 / 90)
    jcfg, tcfg = _cfgs()
    jslam = JS.run_slam_on_source(JS.ReplaySource(path), cfg=jcfg,
                                  max_keyframes=3)
    tslam = TS.run_slam_on_source(TS.ReplaySource(path), cfg=tcfg,
                                  max_keyframes=3, device="cpu")
    assert tslam.device.type == "cpu"
    assert len(tslam.infos) == len(jslam.infos) == 3
    assert int(tslam.state.graph.n_vertices) == int(
        jslam.state.graph.n_vertices) >= 2
    d = tslam.poses.astype(np.float64) - np.asarray(jslam.poses)
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(d).max() <= 1e-3, np.abs(d).max()


def _drive(port, odoms, geometry=True):
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    time.sleep(0.1)
    if geometry:
        tx.sendto(json.dumps({"geometry": {
            "beams": 8, "first_beam_angle": -1.5, "angular_step": 0.4,
            "max_range": 5.0, "laser_offset": [0.1, 0.0, 0.0]}}
        ).encode(), ("127.0.0.1", port))
    for o in odoms:
        tx.sendto(json.dumps({"odom": o, "ranges": [2.0] * 8}).encode(),
                  ("127.0.0.1", port))
        time.sleep(0.02)
    tx.close()


def _receive(src, port, odoms, geometry=True):
    th = threading.Thread(target=_drive, args=(port, odoms, geometry))
    th.start()
    try:
        geom, pose0, r0 = src.open()
        src._sock.settimeout(1.0)
        rels = [rel for rel, _ in src.read()]
    finally:
        th.join(10.0)
        src.close()
    assert not th.is_alive()
    return geom, pose0, r0, rels


def test_udp_json_live_source():
    """A driver feeds absolute odometry over a datagram socket; both
    packages' sources derive the same float64 increments."""
    rng = np.random.default_rng(0)
    odoms = np.cumsum(rng.normal(0, 0.3, (6, 3)), 0).tolist()
    port = free_base_port(1, slot=7) + 1
    got = _receive(TS.UdpJsonSource(port, timeout=5.0), port, odoms)
    want = _receive(JS.UdpJsonSource(port, timeout=5.0), port, odoms)
    geom = got[0]
    assert geom.beams == 8 and abs(geom.laser_offset[0] - 0.1) < 1e-9
    assert TS.SensorGeometry(**vars(want[0])) == geom
    np.testing.assert_array_equal(got[1], odoms[0])
    assert len(got[3]) == len(want[3]) == len(odoms) - 1
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(want[3]))
    # no geometry header: a symmetric π field of view, as the reference
    got = _receive(TS.UdpJsonSource(port, timeout=5.0), port, odoms[:2],
                   geometry=False)
    assert (got[0].beams, got[0].first_beam_angle, got[0].angular_step,
            got[0].max_range) == (8, -np.pi / 2, np.pi / 8, 2.0)


def test_udp_json_source_times_out():
    port = free_base_port(1, slot=8) + 1
    src = TS.UdpJsonSource(port, timeout=0.2)
    try:
        with pytest.raises(TimeoutError):
            src.open()
    finally:
        src.close()
