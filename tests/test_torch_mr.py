"""Parity of the port's multi-robot layer (``mr/condensed.py``,
``mr/mrslam.py``, ``mr/sim.py``, ``mr/network.py``) with ``cg_mrslam_tpu``,
function by function and for the in-process deployment as a whole.

Inputs come from the reference's own test helpers and simulator (seeded
numpy) and cross to the port with ``convert.py``. Bars and why:

* message building and bookkeeping (combos, closure lists, parking, the
  closure buffers' integer fields, vertex/edge masks) are integer or
  boolean: exact;
* poses written from a message or a match: 1e-5 (float32 copies and one
  ``se2`` composition);
* condensed stars: ``z`` 1e-4 (a relative pose after one GN settle that
  both sides solve in float32), packed information rtol 2e-2 of the
  largest entry (the inverse of a marginal covariance, amplified by the
  Hessian's condition; the reference's own chain-vs-dense bar is 5e-2);
* one exchange round from identical states: discrete outcomes equal,
  poses 1e-4, star information as above;
* the scaled replay (``tests/test_mrslam.py``'s deployment cut to 40
  ticks): foreign-vertex counts equal, inter-robot closures within ±1 and
  spliced star edges within ±1 (a closure one side accepts on a float32
  near-tie adds one boundary vertex to the star), judged on outcomes as in
  ``test_torch_pipeline.py``.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_mrslam_tpu.config import Config, MatcherConfig, MRConfig, SlamConfig
from cg_mrslam_tpu.core import graph as JG
from cg_mrslam_tpu.mr import condensed as JCG
from cg_mrslam_tpu.mr import mrslam as JMR
from cg_mrslam_tpu.mr import network as JNET
from cg_mrslam_tpu.mr import sim as JMS
from cg_mrslam_tpu.sim import world as JW
from cg_mrslam_tpu.solver import chain as JCH
from cg_mrslam_tpu_torch import config as tconfig
from cg_mrslam_tpu_torch import convert
from cg_mrslam_tpu_torch.core import graph as TG
from cg_mrslam_tpu_torch.mr import condensed as TCG
from cg_mrslam_tpu_torch.mr import mrslam as TMR
from cg_mrslam_tpu_torch.mr import network as TNET
from cg_mrslam_tpu_torch.mr import sim as TMS
from cg_mrslam_tpu_torch.solver import chain as TCH
from cg_mrslam_tpu_torch.solver import gauss_newton as tgn
from test_closure_rotation import _states as _rotation_states
from test_combo_refresh import _state as _combo_state
from test_condensed import _merged_content, _random_graph
from torch_port_helpers import CPU, assert_same_fields, jf, npy, port, tf

torch.set_num_threads(1)

TICKS = 40


def _mr(st) -> TMR.MRState:
    return convert.mr_state_from_numpy(convert.to_numpy(st), CPU)


def _msg(cls, msg):
    return convert.message_from_numpy(cls, msg, CPU)


def _star_close(got, want):
    np.testing.assert_array_equal(npy(got.valid), npy(want.valid))
    np.testing.assert_array_equal(npy(got.boundary), npy(want.boundary))
    np.testing.assert_array_equal(npy(got.gauge), npy(want.gauge))
    keep = npy(want.valid)
    np.testing.assert_allclose(npy(got.z)[keep], npy(want.z)[keep],
                               atol=1e-4)
    w = npy(want.info)[keep].astype(np.float64)
    np.testing.assert_allclose(npy(got.info)[keep], w, rtol=2e-2,
                               atol=2e-2 * np.abs(w).max())


def _graph_close(got, want, atol=1e-4, info_rtol=2e-2):
    """Two pose graphs: every integer/boolean field exact, poses and edge
    measurements to ``atol``, information to ``info_rtol`` of the
    largest entry."""
    a, b = convert.to_numpy(got), convert.to_numpy(want)
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        if b[k].dtype.kind != "f":
            np.testing.assert_array_equal(x, y, err_msg=k)
        elif k.endswith("e_info"):
            np.testing.assert_allclose(x, y, rtol=info_rtol,
                                       atol=info_rtol * np.abs(y).max(),
                                       err_msg=k)
        else:
            d = x - y
            if k.endswith("poses") or k.endswith("e_z"):
                d[..., 2] = (d[..., 2] + np.pi) % (2 * np.pi) - np.pi
            np.testing.assert_allclose(d, 0.0, atol=atol, err_msg=k)


# --------------------------------------------------------------- condense


def test_select_gauge_and_condense_dense_band():
    """Capacity 32 (the dense SPD band): ``tests/test_condensed.py``'s
    random graph, boundary padded, gauge by the centroid rule."""
    jg = _random_graph()
    tg = port(jg, TG.PoseGraph)
    boundary = np.asarray([2, 7, 13, 20, 0], np.int32)
    valid = np.asarray([True, True, True, True, False])
    jgauge = JCG.select_gauge_centroid(jg, jf(boundary), jnp.asarray(valid))
    tgauge = TCG.select_gauge_centroid(tg, tf(boundary),
                                       torch.as_tensor(valid))
    assert int(tgauge) == int(jgauge)
    want = JCG.condense(jg, jf(boundary), jnp.asarray(valid), jgauge,
                        jg.emask)
    got = TCG.condense(tg, tf(boundary), torch.as_tensor(valid), tgauge,
                       tg.emask)
    assert int(npy(got.valid).sum()) == 3
    _star_close(got, want)


def test_condense_chain_band_matches_reference():
    """Capacity 512 (above DENSE_MAX, the path's own capacity): the
    own-edge subgraph of a merged graph under the (owner, keyframe)
    permutation takes the chain band on both sides."""
    jg, vo, vr, own_slots = _merged_content(512, 2048)
    tg = port(jg, TG.PoseGraph)
    jown = JG.own_edge_mask(jg, 0)
    town = TG.own_edge_mask(tg, 0)
    jorder = JCH.chain_order(vo, vr, jg.vmask)
    torder = TCH.chain_order(tf(np.asarray(vo)), tf(np.asarray(vr)),
                             tg.vmask)
    np.testing.assert_array_equal(npy(torder), np.asarray(jorder))
    assert bool(TCH.chainable(tg, town, loop_cap=64, order=torder))
    boundary = np.asarray([own_slots[5], own_slots[100], own_slots[250],
                           own_slots[340]], np.int32)
    valid = np.ones(4, bool)
    jgauge = JCG.select_gauge_centroid(jg, jf(boundary), jnp.asarray(valid))
    tgauge = TCG.select_gauge_centroid(tg, tf(boundary),
                                       torch.as_tensor(valid))
    assert int(tgauge) == int(jgauge)
    tgn.BAND_CALLS.clear()
    want = JCG.condense(jg, jf(boundary), jnp.asarray(valid), jgauge, jown,
                        jorder)
    got = TCG.condense(tg, tf(boundary), torch.as_tensor(valid), tgauge,
                       town, torder)
    assert tgn.BAND_CALLS == {("optimize_auto", "chain"): 1,
                              ("marginal_covariance_auto", "chain"): 1}
    _star_close(got, want)


def test_splice_star_matches_reference():
    """Replace-then-insert of a peer's star, twice (idempotent under
    resend), on ``tests/test_condensed.py``'s graph."""
    jg = _random_graph(seed=3)
    tg = port(jg, TG.PoseGraph)
    boundary = jf(np.asarray([3, 9, 15, 0], np.int32))
    valid = jnp.asarray([True, True, True, False])
    gauge = JCG.select_gauge_centroid(jg, boundary, valid)
    jstar = JCG.condense(jg, boundary, valid, gauge, jg.emask)
    tstar = _msg(TCG.Star, jstar)
    for _ in range(2):
        jg = JCG.splice_star(jg, jstar, 1)
        tg = TCG.splice_star(tg, tstar, 1)
        assert_same_fields(tg, jg)
    assert int(npy(tg.emask & (tg.e_level == 2)).sum()) == int(
        np.asarray(jstar.valid).sum())


# ------------------------------------------------------ messages, parking


def test_receive_combo_matches_reference():
    """``tests/test_combo_refresh.py``'s states: a first combo parks the
    sender's newest vertex; after the sender re-optimizes, a second combo
    refreshes the parked estimates; a dead delivery changes nothing."""
    jr, _ = _combo_state(my_id=0)
    js, _ = _combo_state(my_id=1)
    tr, ts = _mr(jr), _mr(js)
    jc, tc = JMR.build_combo(js), TMR.build_combo(ts)
    assert_same_fields(tc, jc)
    jr = JMR.receive_combo(jr, jc, jnp.asarray(True))
    tr = TMR.receive_combo(tr, tc, True)
    assert_same_fields(tr, jr)
    moved = js.slam.graph.poses + jnp.asarray([0.0, 0.3, 0.05])
    js = dataclasses.replace(js, slam=dataclasses.replace(
        js.slam, graph=dataclasses.replace(js.slam.graph, poses=moved)))
    ts = _mr(js)
    jc, tc = JMR.build_combo(js), TMR.build_combo(ts)
    for live in (False, True):
        jr = JMR.receive_combo(jr, jc, jnp.asarray(live))
        tr = TMR.receive_combo(tr, tc, live)
        assert_same_fields(tr, jr, atol=1e-6)
    assert int(npy(tr.parked).sum()) == 1


def test_closure_list_rotation_and_union():
    """``tests/test_closure_rotation.py``: 40 accepted closures through a
    16-wide list, rotated by ``off``; the receiver's union covers all."""
    js, jr = _rotation_states()
    ts, tr = _mr(js), _mr(jr)
    off = 0
    for _ in range(4):
        jcl = JMR.build_closure_list(js, jnp.asarray(1, jnp.int32), cap=16,
                                     off=jnp.asarray(off))
        tcl = TMR.build_closure_list(ts, 1, cap=16, off=off)
        assert_same_fields(tcl, jcl)
        jr = JMR.receive_closure_list(jr, jnp.asarray(0, jnp.int32), jcl,
                                      jnp.asarray(True))
        tr = TMR.receive_closure_list(tr, 0, tcl, True)
        np.testing.assert_array_equal(npy(tr.in_closures),
                                      np.asarray(jr.in_closures))
        off = (off + 16) % 40
    assert npy(tr.in_closures)[0, :40].all()


def test_network_masks():
    pos = np.asarray([[0, 0], [3, 4], [9, 0]], np.float32)
    np.testing.assert_array_equal(
        npy(TNET.sim_connectivity(tf(pos), 5.5)),
        np.asarray(JNET.sim_connectivity(jf(pos), 5.5)))
    np.testing.assert_array_equal(npy(TNET.real_connectivity(3)),
                                  np.asarray(JNET.real_connectivity(3)))
    age = np.asarray([[0, 3, 12], [3, 0, 9], [12, 11, 0]], np.float32)
    np.testing.assert_array_equal(
        npy(TNET.bag_connectivity(tf(age), 10.0)),
        np.asarray(JNET.bag_connectivity(jf(age), 10.0)))
    jl, tl = JNET.PingLog(3), TNET.PingLog(3)
    for t, h, s in [(0.5, 0, 1), (2.0, 1, 2), (14.0, 2, 0), (15.0, 0, 1)]:
        jl.record(t, h, s)
        tl.record(t, h, s)
    for t in (1.0, 12.0, 20.0):
        np.testing.assert_array_equal(npy(tl.connectivity(t, 10.0)),
                                      np.asarray(jl.connectivity(t, 10.0)))


# ------------------------------------------------------- the deployment


def _cfgs():
    """``tests/test_mrslam.py``'s deployment in both packages."""
    def build(m):
        return m.Config(
            slam=m.SlamConfig(min_inliers=4, window_loop_closure=8),
            mr=m.MRConfig(n_robots=2, min_inliers_mr=4, sim_comm_range=6.0,
                          max_score_mr=0.2),
            close_matcher=m.MatcherConfig(extent=16.0, resolution=0.05,
                                          kernel_radius=0.2),
            lc_matcher=m.MatcherConfig(extent=24.0, resolution=0.1,
                                       kernel_radius=0.5),
            max_vertices=192, max_edges=1024)

    class Ref:
        Config, SlamConfig, MatcherConfig, MRConfig = (
            Config, SlamConfig, MatcherConfig, MRConfig)

    return build(Ref), build(tconfig)


def _outcomes(st):
    """(vertices, foreign vertices, inter-robot closures, star edges)."""
    g = st.slam.graph
    vm, vo = npy(g.vmask), npy(st.slam.v_owner)
    em = npy(g.emask)
    ij, lvl = npy(g.e_ij)[em], npy(g.e_level)[em]
    me = int(npy(st.slam.my_id))
    return (int(npy(g.n_vertices)), int(((vo != me) & vm).sum()),
            int(((vo[ij[:, 0]] != vo[ij[:, 1]]) & (lvl == 0)).sum()),
            int((lvl > 0).sum()))


@pytest.fixture(scope="module")
def replays():
    """The reference's and the port's ``MultiRobotSim`` over the same
    scans (the reference simulator's), ``TICKS`` ticks."""
    jcfg, tcfg = _cfgs()
    world = JW.hospital_world(width=16.0, height=10.0, seed=2)
    jsim = JMS.MultiRobotSim(jcfg, world, beams=120, seed=11, n_loops=2,
                             width=16.0, height=10.0)
    before = {}
    exchange = jsim.exchange_round

    def recording(t, modality="sim"):
        before.update(t=t, states=list(jsim.states))
        exchange(t, modality)

    jsim.exchange_round = recording
    jsim.run(max_ticks=TICKS)
    jsim.exchange_round = exchange
    tsim = TMS.MultiRobotSim(tcfg, None, beams=120, seed=11, n_loops=2,
                             width=16.0, height=10.0, device="cpu",
                             trajectories=jsim.trajs)
    tsim.run(max_ticks=TICKS)
    return dict(jcfg=jcfg, tcfg=tcfg, jsim=jsim, tsim=tsim,
                jstates=list(jsim.states), tstates=list(tsim.states),
                last_t=before["t"], jbefore=before["states"])


def test_scaled_replay_matches_reference(replays):
    jo = [_outcomes(s) for s in replays["jstates"]]
    to = [_outcomes(s) for s in replays["tstates"]]
    for (jv, jf_, ji, js), (tv, tf_, ti, ts) in zip(jo, to):
        assert (tv, tf_) == (jv, jf_), (to, jo)
        assert abs(ti - ji) <= 1 and abs(ts - js) <= 1, (to, jo)
    # the deployment did its work: foreign vertices, inter-robot
    # closures and spliced stars on both robots
    assert all(f > 3 and i > 0 and s > 0 for _, f, i, s in to), to
    np.testing.assert_array_equal(
        replays["tsim"].closure_stats, replays["jsim"].closure_stats)
    for r in range(2):
        assert all(np.isfinite(i.chi2) for i in replays["tsim"].infos[r])


def _twins(replays):
    """The reference's states going into its last exchange round, and the
    same states in the port."""
    jstates = list(replays["jbefore"])
    return jstates, [_mr(s) for s in jstates]


def test_try_match_parked_and_vote_from_identical_state(replays):
    """Each robot receives its peer's combo, then matches its newest
    parked vertex (kernel K2's plain version on the CPU) and votes, from
    states carried across from the reference."""
    jcfg, tcfg = replays["jcfg"], replays["tcfg"]
    jstates, tstates = _twins(replays)
    parked = matched = 0
    for r in range(2):
        s = 1 - r
        jst = JMR.receive_combo(jstates[r], JMR.build_combo(jstates[s]),
                                jnp.asarray(True))
        tst = TMR.receive_combo(tstates[r], TMR.build_combo(tstates[s]),
                                True)
        assert_same_fields(tst, jst, atol=1e-6)
        parked += int(npy(tst.parked).sum())
        jst = JMR.try_match_parked(jst, jcfg)
        tst = TMR.try_match_parked(tst, tcfg)
        assert_same_fields(tst.peer_buf, jst.peer_buf, atol=1e-4)
        for f in ("parked", "park_age"):
            np.testing.assert_array_equal(npy(getattr(tst, f)),
                                          np.asarray(getattr(jst, f)))
        _graph_close(tst.slam.graph, jst.slam.graph)
        matched += int(npy(tst.peer_buf.mask).sum())
        jst = JMR.vote_inter_robot(jst, jcfg)
        tst = TMR.vote_inter_robot(tst, tcfg)
        np.testing.assert_array_equal(npy(tst.out_closures),
                                      np.asarray(jst.out_closures))
        assert_same_fields(tst.peer_buf, jst.peer_buf, atol=1e-4)
        _graph_close(tst.slam.graph, jst.slam.graph)
    assert parked > 0 and matched > 0, (parked, matched)


def test_exchange_round_from_identical_state(replays):
    """The reference's last exchange round (combos, matching, vote,
    closure lists, condensed stars), replayed by the port on the states
    that went into it, carried across."""
    t = replays["last_t"]
    _, tstates = _twins(replays)
    tsim = copy.copy(replays["tsim"])
    tsim.states = tstates
    np.testing.assert_array_equal(
        tsim.connectivity(t, "sim"),
        np.asarray(replays["jsim"].connectivity(t, "sim")))
    tsim.exchange_round(t)
    for jst, tst in zip(replays["jstates"], tsim.states):
        for f in ("parked", "park_age", "in_closures", "out_closures"):
            np.testing.assert_array_equal(npy(getattr(tst, f)),
                                          np.asarray(getattr(jst, f)),
                                          err_msg=f)
        assert_same_fields(tst.peer_buf, jst.peer_buf, atol=1e-4)
        _graph_close(tst.slam.graph, jst.slam.graph)
        assert _outcomes(tst)[3] > 0
