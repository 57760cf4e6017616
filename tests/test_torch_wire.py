"""The port's wire codec (``cg_mrslam_tpu_torch/mr/wire.py``) and its
full-graph fallback messages (``mr/mrslam.py``: ``build_graph_msg``,
``receive_graph_msg``) against ``cg_mrslam_tpu``: the cases of
``tests/test_wire.py``, each through both packages.

Bars and why:

* ``encode`` writes the reference's bytes exactly, for all eight message
  types: the codec reorders nothing and only converts to float32, and a
  process of one package must talk to a process of the other;
* each package decodes the other's bytes to equal values (exact: the same
  float32 words, the integers and flags converted back the same way);
* a combo of another beam count is resampled by the port's node exactly as
  the reference's ``resample_scan_np`` does, onto the node's device;
* a message over ``MAX_DATAGRAM`` raises in both;
* ``build_graph_msg`` / ``receive_graph_msg`` from identical states give
  equal slots, owners, edge sets and levels (integers and masks: exact),
  poses within 1e-6 (float32 copies), including a message that repeats an
  index and overflows the receiver's capacity.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_mrslam_tpu.core.scan import resample_scan_np as jresample
from cg_mrslam_tpu.mr import mrslam as JMR
from cg_mrslam_tpu.mr import wire as jwire
from cg_mrslam_tpu_torch import convert
from cg_mrslam_tpu_torch.config import Config, MRConfig
from cg_mrslam_tpu_torch.mr import mrslam as TMR
from cg_mrslam_tpu_torch.mr import wire as twire
from cg_mrslam_tpu_torch.mr.node import RobotNode
from test_wire import _state as _jstate
from torch_port_helpers import CPU, Loopback, assert_same_fields, jf, npy

torch.set_num_threads(1)


def _mr(st) -> TMR.MRState:
    return convert.mr_state_from_numpy(convert.to_numpy(st), CPU)


def _messages():
    """One message of each type, in the reference's types, from a seed."""
    rng = np.random.default_rng(7)
    st, _ = _jstate(my_id=1)
    e = 3
    return {
        "ping": jwire.Ping(robot=1, x=1.25, y=-3.5),
        "combo": JMR.build_combo(st),
        "vertex_array": JMR.VertexArray(
            robot=jf(2), poses=jf(rng.normal(size=(4, 3))),
            idxs=jf(np.asarray([7, 8, 9, -1])),
            valid=jnp.asarray([True, True, True, False])),
        "robot_laser": JMR.RobotLaser(
            robot=jf(1), node_id=jf(5),
            ranges=jf(rng.uniform(0.2, 8.0, 64)),
            first_beam_angle=jnp.float32(-1.5),
            angular_step=jnp.float32(0.05), max_range=jnp.float32(8.0),
            accuracy=jnp.float32(0.02)),
        "edge_array": JMR.EdgeArray(
            robot=jf(0), ids=jf(np.asarray([[0, 1], [1, 2], [2, 5]])),
            z=jf(rng.normal(size=(e, 3))),
            info=jf(rng.uniform(1, 1000, (e, 6))),
            valid=jnp.asarray([True, True, False])),
        "closure_list": JMR.ClosureList(
            idxs=jf(np.asarray([3, 5, 0])),
            valid=jnp.asarray([True, True, False])),
        "star": JMR.StarMsg(
            gauge=jf(4), boundary=jf(np.asarray([1, 2])),
            z=jf(rng.normal(size=(2, 3))),
            info=jf(rng.uniform(1, 1000, (2, 6))),
            valid=jnp.asarray([True, False])),
        "graph": JMR.build_graph_msg(st),
    }


PORT_TYPES = {"combo": TMR.Combo, "vertex_array": TMR.VertexArray,
              "robot_laser": TMR.RobotLaser, "edge_array": TMR.EdgeArray,
              "closure_list": TMR.ClosureList, "star": TMR.StarMsg,
              "graph": TMR.GraphMsg}


def _port(name, msg):
    if name == "ping":
        return twire.Ping(*msg)
    fields = convert.to_numpy(msg)
    if name in ("closure_list", "star"):
        fields["dropped"] = np.asarray(0, np.int32)
    return convert.from_numpy(PORT_TYPES[name], fields, CPU)


def _same_values(a, b):
    """Two messages (either package) hold equal values, field by field."""
    fa, fb = convert.to_numpy(a), convert.to_numpy(b)
    for k in fa.keys() & fb.keys():
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.shape == y.shape, k
        if x.dtype.kind == "f" or y.dtype.kind == "f":
            np.testing.assert_array_equal(x.astype(np.float32),
                                          y.astype(np.float32), err_msg=k)
        else:
            np.testing.assert_array_equal(x.astype(np.int64),
                                          y.astype(np.int64), err_msg=k)


NAMES = list(_messages())


@pytest.fixture(scope="module")
def messages():
    return _messages()


@pytest.mark.parametrize("name", NAMES)
def test_encode_writes_the_references_bytes(messages, name):
    msg = messages[name]
    robot = {"closure_list": 1, "star": 1}.get(name, -1)
    want = jwire.encode(msg, robot=robot)
    got = twire.encode(_port(name, msg), robot=robot)
    assert len(want) < twire.MAX_DATAGRAM
    assert got == want


@pytest.mark.parametrize("name", NAMES)
def test_each_package_decodes_the_others_bytes(messages, name):
    msg = messages[name]
    robot = {"closure_list": 1, "star": 1}.get(name, -1)
    buf = jwire.encode(msg, robot=robot)
    js, jback = jwire.decode(buf)
    ts, tback = twire.decode(buf, device="cpu")
    assert js == ts and type(tback).__name__ == type(jback).__name__
    _same_values(tback, jback)
    # and the other way: the reference reads the port's datagram
    js2, jback2 = jwire.decode(twire.encode(tback, robot=robot))
    assert js2 == js
    _same_values(jback2, jback)
    if name != "ping":
        leaves = [v for v in tback if isinstance(v, torch.Tensor)]
        assert leaves and all(v.device == CPU for v in leaves)


def test_malformed_datagrams_raise_value_error(messages):
    buf = twire.encode(_port("combo", messages["combo"]))
    for bad in (buf[:8], buf[:-4], b"\x63\x00\x00\x00" + buf[4:]):
        with pytest.raises(ValueError):
            twire.decode(bad, device="cpu")


def test_heterogeneous_beams_resampled_by_the_node():
    """A 64-beam peer's combo (the reference's bytes) reaches a 32-beam
    port node: resampled as the reference resamples it, on the node's
    device, with the node's geometry."""
    fov = 2 * np.pi * 0.75
    b_src, b_dst, maxr = 64, 32, 8.0
    src_fba, src_step = -fov / 2, fov / b_src
    a = src_fba + src_step * np.arange(b_src)
    ranges = np.clip(3.0 + np.sin(a) * 2.0, 0.2, maxr).astype(np.float32)
    ranges[10] = maxr
    combo = JMR.Combo(
        robot=jf(1), poses=jf(np.zeros((5, 3))), idxs=jf(np.arange(5)),
        valid=jnp.ones(5, bool), ranges=jf(ranges),
        first_beam_angle=jnp.float32(src_fba),
        angular_step=jnp.float32(src_step), max_range=jnp.float32(maxr))
    cfg = Config(max_vertices=64, max_edges=256, mr=MRConfig(n_robots=2))
    node = RobotNode(cfg, 0, b_dst, np.zeros(3), np.full(b_dst, 5.0), fov,
                     maxr, Loopback(2).endpoint(0), device="cpu")
    _, msg = twire.decode(jwire.encode(combo), device="cpu")
    out = node._to_my_geometry(msg)
    want = jresample(ranges, float(np.float32(src_fba)),
                     float(np.float32(src_step)), maxr, b_dst, -fov / 2,
                     fov / b_dst, maxr)
    assert out.ranges.device == node.device and out.ranges.shape == (b_dst,)
    np.testing.assert_allclose(npy(out.ranges), want, atol=1e-6)
    s = node.state.slam.scans
    assert float(out.angular_step) == float(s.angular_step)
    # the same geometry passes through untouched
    assert node._to_my_geometry(out) is out


def test_oversize_message_raises_in_both():
    b = 30000   # 120 kB of ranges
    jc = JMR.Combo(robot=jf(0), poses=jf(np.zeros((5, 3))),
                   idxs=jf(np.arange(5)), valid=jnp.ones(5, bool),
                   ranges=jf(np.ones(b)))
    with pytest.raises(ValueError, match="datagram bound"):
        jwire.encode(jc)
    tc = TMR.Combo(robot=torch.tensor(0), poses=torch.zeros(5, 3),
                   idxs=torch.arange(5, dtype=torch.int32),
                   valid=torch.ones(5, dtype=torch.bool),
                   ranges=torch.ones(b), first_beam_angle=torch.tensor(0.0),
                   angular_step=torch.tensor(0.01),
                   max_range=torch.tensor(8.0))
    with pytest.raises(ValueError, match="datagram bound"):
        twire.encode(tc)


def test_graph_msg_fallback_merge_matches_reference():
    """``tests/test_wire.py``'s case: robot 0's graph message merged into
    robot 1's state, resent (idempotent), and undelivered (no change)."""
    j0, _ = _jstate(my_id=0)
    j1, _ = _jstate(my_id=1)
    t0, t1 = _mr(j0), _mr(j1)
    jmsg, tmsg = JMR.build_graph_msg(j0), TMR.build_graph_msg(t0)
    assert_same_fields(tmsg, jmsg)
    assert int(npy(tmsg.vvalid).sum()) == 6
    assert int(npy(tmsg.evalid).sum()) == 5
    for live in (True, True, False):
        j1 = JMR.receive_graph_msg(j1, jmsg, jnp.asarray(live))
        t1 = TMR.receive_graph_msg(t1, tmsg, live)
        assert_same_fields(t1, j1, atol=1e-6)
    vm = npy(t1.slam.graph.vmask)
    assert (npy(t1.slam.v_owner)[vm] == 0).sum() == 6
    lvl = npy(t1.slam.graph.e_level)[npy(t1.slam.graph.emask)]
    assert (lvl == 1).sum() == 5


def test_graph_msg_repeats_and_capacity_match_reference():
    """A hand-made message with repeated indices (valid and not) into a
    receiver with fewer free slots than new vertices: the vectorised merge
    gives the reference's slots, vertex count and edges."""
    rng = np.random.default_rng(3)
    j1, _ = _jstate(my_id=1)
    v, e = 72, 12
    idxs = rng.permutation(1000)[:v].astype(np.int32)
    idxs[5] = idxs[2]                      # a repeat before the overflow
    idxs[70] = idxs[64]                    # a repeat of a dropped entry
    idxs[66] = idxs[3]                     # a repeat of a placed entry
    vvalid = rng.uniform(size=v) > 0.1
    vvalid[[2, 3, 5, 64, 66, 70]] = True
    vvalid[9] = False
    idxs[11] = idxs[9]                     # an invalid entry's repeat
    ij = idxs[rng.integers(0, v, (e, 2))]
    jmsg = JMR.GraphMsg(
        robot=jf(0), poses=jf(rng.normal(size=(v, 3))), idxs=jf(idxs),
        vvalid=jnp.asarray(vvalid), e_ij=jf(ij),
        e_z=jf(rng.normal(size=(e, 3))), e_info=jf(rng.uniform(1, 9, (e, 6))),
        evalid=jnp.asarray(rng.uniform(size=e) > 0.2))
    tmsg = convert.from_numpy(TMR.GraphMsg, convert.to_numpy(jmsg), CPU)
    j2 = JMR.receive_graph_msg(j1, jmsg, jnp.asarray(True))
    t2 = TMR.receive_graph_msg(_mr(j1), tmsg, True)
    assert int(j2.slam.graph.n_vertices) > 64      # it did overflow
    assert_same_fields(t2, j2, atol=1e-6)
    j3 = JMR.receive_graph_msg(j1, jmsg, jnp.asarray(False))
    t3 = TMR.receive_graph_msg(_mr(j1), tmsg, False)
    assert_same_fields(t3, j3)
