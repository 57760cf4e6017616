"""Parity of the port's fleet round (``parallel/fleet.py``) with
``cg_mrslam_tpu.parallel.fleet``, in one process and as a multi-process
``torch.distributed`` program (gloo on the CPU).

States come from the reference's scaled two-robot deployment
(``tests/test_torch_mr.py``'s config, ``TICKS`` ticks) and from
``tests/test_fleet.py``'s four-robot block scene, carried across with
``convert.py``. Bar: ``tests/test_fleet.py:_flat_cmp`` — integer and bool
leaves (graph structure, counts, accepted closures) exact; float leaves
within 1e-3 + 1e-5 of the leaf's largest magnitude (two differently
ordered float32 programs; GN iterations amplify last-bit drift, and a
condensed star's information is a covariance inverse whose error scales
with its size). The sharded round is held to the in-process port round
at the same bar.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_mrslam_tpu.config import Config, MatcherConfig, MRConfig
from cg_mrslam_tpu.core import graph as JG
from cg_mrslam_tpu.mr import mrslam as JMR
from cg_mrslam_tpu.mr import sim as JMS
from cg_mrslam_tpu.parallel import fleet as JF
from cg_mrslam_tpu.sim import world as JW
from cg_mrslam_tpu_torch import config as tconfig
from cg_mrslam_tpu_torch import convert
from cg_mrslam_tpu_torch.mr import mrslam as TMR
from cg_mrslam_tpu_torch.parallel import fleet as TF
from cg_mrslam_tpu_torch.parallel.launch import run_group
from test_torch_mr import _cfgs
from torch_port_helpers import CPU, assert_same_fields
import torch_dist_workers as workers

torch.set_num_threads(1)

TICKS = 40
GROUP_TIMEOUT = 120.0


def _flat_cmp(a: dict, b: dict, atol=1e-3):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if y.dtype == bool or np.issubdtype(y.dtype, np.integer):
            np.testing.assert_array_equal(x.astype(np.int64),
                                          y.astype(np.int64), err_msg=k)
            continue
        scale = float(np.abs(y).max()) if y.size else 0.0
        np.testing.assert_allclose(x, y, atol=atol + 1e-5 * scale,
                                   err_msg=k)


def _mr(st) -> TMR.MRState:
    return convert.mr_state_from_numpy(convert.to_numpy(st), CPU)


@pytest.fixture(scope="module")
def scene():
    """The reference's two-robot states after ``TICKS`` ticks, the full
    connectivity, and both packages' configs."""
    jcfg, tcfg = _cfgs()
    world = JW.hospital_world(width=16.0, height=10.0, seed=2)
    jsim = JMS.MultiRobotSim(jcfg, world, beams=120, seed=11, n_loops=2,
                             width=16.0, height=10.0)
    jsim.run(max_ticks=TICKS)
    conn = np.ones((2, 2), bool) & ~np.eye(2, dtype=bool)
    return dict(jcfg=jcfg, tcfg=tcfg, jstates=list(jsim.states), conn=conn)


def test_stack_unstack_round_trip(scene):
    states = [_mr(s) for s in scene["jstates"]]
    batched = TF.stack_states(states)
    assert batched.slam.graph.poses.shape[0] == 2
    assert batched.peer_buf.mask.shape[0] == 2
    for a, b in zip(TF.unstack_states(batched, 2), states):
        assert_same_fields(a, b)
    # the same leaves, in the same order, as the reference's stacked tree
    assert_same_fields(batched, JF.stack_states(scene["jstates"]))


def test_dead_deliveries_change_nothing(scene):
    """``live=False`` leaves the state as it was: the reference consumes
    every row of its tables under ``live``, the port builds and delivers
    only live messages, and this identity makes the two the same."""
    st, peer = (_mr(s) for s in scene["jstates"])
    combo = TMR.build_combo(peer)
    assert_same_fields(TMR.receive_combo(st, combo, False), st)
    cl = TMR.build_closure_list(peer, 0, cap=16)
    assert bool(cl.valid.any())
    assert_same_fields(TMR.receive_closure_list(st, 1, cl, False), st)
    star = TMR.build_star(peer, 0, cap=16)
    assert bool(star.valid.any())
    assert_same_fields(TMR.receive_star(st, 1, star, False), st)


@pytest.fixture(scope="module")
def rounds(scene):
    """One round from the same states: the reference's ``fleet_round`` and
    the port's."""
    jout = JF.fleet_round(JF.stack_states(scene["jstates"]),
                          jnp.asarray(scene["conn"]), scene["jcfg"])
    tout = TF.fleet_round(TF.stack_states([_mr(s) for s in
                                           scene["jstates"]]),
                          scene["conn"], scene["tcfg"])
    return jout, tout


def test_fleet_round_matches_reference(rounds):
    jout, tout = rounds
    _flat_cmp(convert.to_numpy(tout), convert.to_numpy(jout))
    # the round did its work: a star spliced on each robot
    lvl = tout.slam.graph.e_level.numpy()
    em = tout.slam.graph.emask.numpy()
    assert all(((lvl[r] > 0) & em[r]).any() for r in range(2))


def test_fleet_round_sharded_matches_in_process(scene, rounds, tmp_path):
    """Two gloo processes, one robot each, against the port's in-process
    round."""
    _, tout = rounds
    states = [convert.to_numpy(s) for s in scene["jstates"]]
    res = run_group(workers.sharded_round, 2,
                    args=(states, scene["conn"], scene["tcfg"]),
                    workdir=tmp_path, timeout=GROUP_TIMEOUT)
    got = [s for block in res for s in block]
    for r, want in enumerate(TF.unstack_states(tout, 2)):
        _flat_cmp(got[r], convert.to_numpy(want))


def _block_scene(m, G, MR):
    """``tests/test_fleet.py``'s R = 4 scene in package ``m``."""
    cfg = m.Config(
        mr=m.MRConfig(n_robots=4, sim_comm_range=8.0),
        close_matcher=m.MatcherConfig(extent=8.0, resolution=0.1,
                                      kernel_radius=0.2),
        lc_matcher=m.MatcherConfig(extent=12.0, resolution=0.2,
                                   kernel_radius=0.5),
        max_vertices=32, max_edges=64, max_beams=16)
    beams = 16
    rng = np.random.default_rng(0)
    states = []
    for r in range(4):
        ranges = np.full(beams, 4.0, np.float32)
        st = MR.init_mr_state(cfg, beams, [3.0 * r, 0.0, 0.0], ranges,
                              2 * np.pi * 0.75, 6.0, my_id=r)
        slam = st.slam
        for k in range(1, 4):
            pose = jnp.asarray([3.0 * r + 0.5 * k, 0.0, 0.0])
            slam = dataclasses.replace(
                slam,
                graph=G.add_edge(
                    G.add_vertex(slam.graph, pose), k - 1, k,
                    jnp.asarray([0.5, 0.0, 0.0]),
                    np.asarray([100, 0, 0, 100, 0, 1000], np.float32),
                    owner=r),
                v_owner=slam.v_owner.at[k].set(r),
                v_remote=slam.v_remote.at[k].set(k))
        ranges_all = np.asarray(slam.scans.ranges).copy()
        ranges_all[:4] = 4.0 + 0.2 * rng.random((4, beams))
        smask = np.asarray(slam.scans.smask).copy()
        smask[:4] = True
        slam = dataclasses.replace(
            slam, scans=dataclasses.replace(
                slam.scans, ranges=jnp.asarray(ranges_all),
                smask=jnp.asarray(smask)))
        states.append(dataclasses.replace(st, slam=slam))
    return cfg, states


def test_fleet_round_sharded_robot_blocks(tmp_path):
    """R = 4 robots on 2 processes (a block of 2 per rank) against the
    reference's batched round (``tests/test_fleet.py:94``)."""
    class Ref:
        Config, MatcherConfig, MRConfig = Config, MatcherConfig, MRConfig

    jcfg, jstates = _block_scene(Ref, JG, JMR)
    tcfg = tconfig.Config(
        mr=tconfig.MRConfig(n_robots=4, sim_comm_range=8.0),
        close_matcher=tconfig.MatcherConfig(extent=8.0, resolution=0.1,
                                            kernel_radius=0.2),
        lc_matcher=tconfig.MatcherConfig(extent=12.0, resolution=0.2,
                                         kernel_radius=0.5),
        max_vertices=32, max_edges=64, max_beams=16)
    conn = np.ones((4, 4), bool) & ~np.eye(4, dtype=bool)
    want = JF.fleet_round(JF.stack_states(jstates), jnp.asarray(conn), jcfg)
    res = run_group(workers.sharded_round, 2,
                    args=([convert.to_numpy(s) for s in jstates], conn,
                          tcfg),
                    workdir=tmp_path, timeout=GROUP_TIMEOUT)
    got = [s for block in res for s in block]
    for r, w in enumerate(JF.unstack_states(want, 4)):
        _flat_cmp(got[r], convert.to_numpy(w))
