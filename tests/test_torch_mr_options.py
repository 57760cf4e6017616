"""Parity of the exchange protocol's two options with ``cg_mrslam_tpu``, on
the CPU: the visibility gate of ``try_match_parked``
(``MRConfig.detect_robot_in_range``) and the uncertainty-minimizing gauge
(``condensed.select_gauge_optimal``, ``build_star(gauge_mode="optimal")``).
Both are off by default, as in the reference.

Bars and why (those of ``tests/test_torch_mr.py``):

* the gate's outcome — parked and aged vertices, the buffered hypothesis
  with its integer fields — exact; the moved pose and the hypothesis's
  measurement 1e-4 (one float32 search and one ``se2`` composition);
* the optimal gauge: the same vertex; each candidate's total uncertainty
  Σ det(Ω)⁻¹ within rtol 1e-4 (a float32 condense on both sides);
* the optimal-gauge star: ``test_torch_mr.py``'s condense bars (``z``
  1e-4, information rtol 2e-2 of the largest entry).
"""

import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_mrslam_tpu.config import Config, MRConfig
from cg_mrslam_tpu.core import graph as JG
from cg_mrslam_tpu.mr import condensed as JCG
from cg_mrslam_tpu.mr import mrslam as JMR
from cg_mrslam_tpu.mr import sim as JMS
from cg_mrslam_tpu.sim import world as JW
from cg_mrslam_tpu_torch.core import graph as TG
from cg_mrslam_tpu_torch.mr import condensed as TCG
from cg_mrslam_tpu_torch.mr import mrslam as TMR
from test_condensed import _random_graph
from test_torch_mr import _cfgs, _graph_close, _mr, _star_close
from torch_port_helpers import assert_same_fields, jf, npy, port, tf

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def parked_states():
    """``tests/test_mrslam.py``'s two-robot deployment (the scaled run of
    ``tests/test_torch_mr.py``, 40 ticks) in the reference: before every
    exchange round, each robot receives its peer's combo. Returns the
    states that then hold a parked foreign vertex."""
    jcfg, tcfg = _cfgs()
    jsim = JMS.MultiRobotSim(jcfg, JW.hospital_world(width=16.0, height=10.0,
                                                     seed=2),
                             beams=120, seed=11, n_loops=2, width=16.0,
                             height=10.0)
    states = []
    exchange = jsim.exchange_round

    def recording(t, modality="sim"):
        for r in (0, 1):
            st = JMR.receive_combo(jsim.states[r],
                                   JMR.build_combo(jsim.states[1 - r]),
                                   jnp.asarray(True))
            if bool(np.asarray(st.parked).any()):
                states.append(st)
        exchange(t, modality)

    jsim.exchange_round = recording
    jsim.run(max_ticks=40)
    return jcfg, tcfg, states


def _matched(st) -> int:
    return int(npy(st.peer_buf.mask).sum())


@pytest.mark.parametrize("gate", [True, False])
def test_try_match_parked_gate(parked_states, gate):
    """With and without the gate, from the same states in both packages:
    ``ok`` (as the parked / aged-out bookkeeping and the buffered
    hypothesis), the moved pose, the hypothesis. Among the states, the
    ungated search matches some parked vertices, so the gate decides."""
    jcfg, tcfg, states = parked_states
    jcfg, tcfg = (dc.replace(c, mr=dc.replace(c.mr,
                                              detect_robot_in_range=gate))
                  for c in (jcfg, tcfg))
    assert len(states) >= 4
    found = []
    for jst in states:
        want = JMR.try_match_parked(jst, jcfg)
        got = TMR.try_match_parked(_mr(jst), tcfg)
        for f in ("parked", "park_age"):
            np.testing.assert_array_equal(npy(getattr(got, f)),
                                          np.asarray(getattr(want, f)))
        assert_same_fields(got.peer_buf, want.peer_buf, atol=1e-4)
        _graph_close(got.slam.graph, want.slam.graph)
        found.append(_matched(got) - _matched(_mr(jst)))
    # the simulator draws no robot bodies: the gate rejects what the
    # search matched
    assert sum(found) == (0 if gate else len(states)), found


def _uncertainty(cg, unpack, g, boundary, valid, gauge):
    """Σ det(Ω)⁻¹ over the valid edges of one package's star."""
    star = cg.condense(g, boundary, valid, gauge, g.emask)
    omega = npy(unpack(star.info)).astype(np.float64)
    u = 1.0 / np.maximum(np.linalg.det(omega), 1e-30)
    return float(np.sum(np.where(npy(star.valid), u, 0.0)))


@pytest.mark.parametrize("valid", [[True] * 5, [True, False, True, True,
                                                 False]])
def test_select_gauge_optimal(valid):
    """``tests/test_condensed.py::test_optimal_gauge_minimizes_uncertainty``'s
    graph, with all five candidates valid and with two masked."""
    jg = _random_graph(seed=3)
    tg = port(jg, TG.PoseGraph)
    boundary = np.asarray([1, 6, 12, 19, 23], np.int32)
    valid = np.asarray(valid)
    want = JCG.select_gauge_optimal(jg, jf(boundary), jnp.asarray(valid),
                                    jg.emask)
    got = TCG.select_gauge_optimal(tg, tf(boundary), torch.as_tensor(valid),
                                   tg.emask)
    assert got.shape == () and int(got) == int(want)
    assert valid[list(boundary).index(int(got))]
    for k in np.flatnonzero(valid):
        uj = _uncertainty(JCG, JG.unpack_info, jg, jf(boundary),
                          jnp.asarray(valid), jnp.asarray(boundary[k]))
        ut = _uncertainty(TCG, TG.unpack_info, tg, tf(boundary),
                          torch.as_tensor(valid), tf(boundary[k]))
        np.testing.assert_allclose(ut, uj, rtol=1e-4)


def _star_state():
    """An ``MRState`` holding ``test_condensed.py``'s random graph as its own
    graph, with peer 1 having closed on five of its vertices."""
    cfg = Config(mr=MRConfig(n_robots=2), max_vertices=32, max_edges=96,
                 max_beams=8)
    st = JMR.init_mr_state(cfg, 8, [0.0, 0.0, 0.0],
                           np.full(8, 4.0, np.float32), np.pi, 5.0, my_id=0)
    g = _random_graph(seed=3)
    v_remote = np.where(np.asarray(g.vmask), np.arange(32), -1)
    in_c = np.zeros((2, 32), bool)
    in_c[1, [2, 7, 12, 18, 23]] = True
    slam = dc.replace(st.slam, graph=g,
                      v_remote=jnp.asarray(v_remote, jnp.int32))
    return dc.replace(st, slam=slam, in_closures=jnp.asarray(in_c))


def test_build_star_optimal_gauge():
    jst = _star_state()
    want = JMR.build_star(jst, jnp.asarray(1, jnp.int32),
                          gauge_mode="optimal")
    got = TMR.build_star(_mr(jst), 1, gauge_mode="optimal")
    np.testing.assert_array_equal(npy(got.gauge), np.asarray(want.gauge))
    np.testing.assert_array_equal(npy(got.dropped), np.asarray(want.dropped))
    _star_close(got, want)
    assert int(got.gauge) in npy(got.boundary)[npy(got.valid) | (
        npy(got.boundary) == int(got.gauge))]


@pytest.mark.parametrize("valid", [[True] * 5, [True, False, True, True,
                                                 False]])
def test_gauge_uncertainty_batched(valid):
    """``select_gauge_optimal``'s one batched condense of the valid
    candidates: every candidate's Σ det(Ω)⁻¹ against the reference's
    condense of that candidate (rtol 1e-3: a float32 batched condense,
    summed in other orders than the reference's single one), +inf on an
    invalid slot, and the reference's gauge."""
    jg = _random_graph(seed=3)
    tg = port(jg, TG.PoseGraph)
    boundary = np.asarray([1, 6, 12, 19, 23], np.int32)
    valid = np.asarray(valid)
    u = npy(TCG.gauge_uncertainty(tg, tf(boundary), torch.as_tensor(valid),
                                  tg.emask))
    assert np.all(np.isinf(u[~valid]))
    for k in np.flatnonzero(valid):
        uj = _uncertainty(JCG, JG.unpack_info, jg, jf(boundary),
                          jnp.asarray(valid), jnp.asarray(boundary[k]))
        np.testing.assert_allclose(u[k], uj, rtol=1e-3)
    want = JCG.select_gauge_optimal(jg, jf(boundary), jnp.asarray(valid),
                                    jg.emask)
    assert int(boundary[np.argmin(u)]) == int(want)


def test_gauge_uncertainty_batched_banded():
    """The batched condense above the dense band: the merged two-robot
    fixture (capacity 1024, robot 0's own edges, the PCG band under its
    chain order) with four candidate gauges, each candidate's uncertainty
    against the port's own batch-1 condense of it (rtol 1e-3: the same
    float32 solves, batched). Every candidate is a vertex the own edges
    touch, as every boundary vertex of a request is: one they do not touch
    (slot 330) anchors nothing as the gauge, so its system is singular
    but for the marginals' 1e-6 jitter and its float32 star is noise."""
    from cg_mrslam_tpu_torch.sim.graphs import build_merged_batch
    from cg_mrslam_tpu_torch.solver import gauss_newton as tgn

    gb, order, _ = build_merged_batch(1, device="cpu")
    g = TG.PoseGraph(**{f.name: getattr(gb, f.name)[0]
                        for f in dc.fields(gb)})
    own = TG.own_edge_mask(g, 0)
    boundary = torch.tensor([40, 120, 200, 322], dtype=torch.int32)
    valid = torch.ones(4, dtype=torch.bool)
    tgn.BAND_CALLS.clear()
    u = npy(TCG.gauge_uncertainty(g, boundary, valid, own, order))
    assert set(b for _, b in tgn.BAND_CALLS) <= {"chain", "pcg"}
    for k in range(4):
        star = TCG.condense(g, boundary, valid, boundary[k], own, order)
        omega = npy(TG.unpack_info(star.info)).astype(np.float64)
        uk = np.sum(np.where(npy(star.valid), 1.0 / np.maximum(
            np.linalg.det(omega), 1e-30), 0.0))
        np.testing.assert_allclose(u[k], uk, rtol=1e-3)
