"""The uncertainty-minimizing gauge as a deployment of the port, on the CPU:
``mr.condensed.condense_optimal`` against the plain float64 oracle
(``tests/oracle_condense.py``, torch only), the winner's star taken from
the batch, ``build_star(gauge_mode="optimal")``, ``MRConfig.gauge_mode``
from the command line to every place a star is built, and the spans and
counters of one optimal star.

Bars and why:

* a small graph on the dense band: each candidate's total uncertainty
  Σ det(Ω)⁻¹ within rtol 1e-4, ``z`` within 1e-5 (m, rad), each edge's Ω
  within 1e-5 of its Frobenius norm: one float32 GN×1 and one float32
  marginal solve (an SPD inverse with a CG polish) against float64; three
  seeds read at most 1.1e-5, 4.4e-7 and 1.7e-7 (Σ det⁻¹ sums the
  least certain edges, whose determinants lose the most digits);
* robot 0's own edges of the merged two-robot fixture at capacity 1024
  (the PCG band) with three candidates: uncertainty rtol 2e-5, ``z`` 2e-5,
  Ω 2e-5 relative: float32 CG at the condense's budgets converges to
  float32 rounding of a 3072-wide system; two seeds read at most 7.0e-7,
  4.2e-6 and 6.9e-7;
* the winner from the batch and a fresh condense at its gauge: the same
  solves in another batch size, so float32 rounding: ``z`` 1e-5, Ω 1e-4
  relative;
* the gauge: the oracle's, exactly (the candidates' uncertainties differ
  by far more than the bars).
"""

from __future__ import annotations

import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import oracle_condense as oracle
from cg_mrslam_tpu_torch import cli
from cg_mrslam_tpu_torch.config import Config, MRConfig
from cg_mrslam_tpu_torch.core import graph as G
from cg_mrslam_tpu_torch.mr import condensed as CG
from cg_mrslam_tpu_torch.mr import mrslam as MR
from cg_mrslam_tpu_torch.solver import gauss_newton as gn
from cg_mrslam_tpu_torch.solver.chain import chain_order
from cg_mrslam_tpu_torch.utils import metrics as M

torch.set_num_threads(2)

FIXTURE = (Path(__file__).resolve().parent / "fixtures"
           / "merged_2robot_1024.npz")


def _small_graph(seed: int = 5) -> G.PoseGraph:
    """24 poses along a closed loop in 32 slots, odometry and six
    closures (robot 0's), two edges of robot 1 (not condensed), noisy
    poses; vertex 0 fixed."""
    rng = np.random.default_rng(seed)
    n, e, live = 32, 96, 24
    th = np.linspace(0, 2 * np.pi, live, endpoint=False)
    truth = np.stack([4 * np.cos(th), 3 * np.sin(th), th + np.pi / 2], 1)

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         np.arctan2(np.sin(b[2] - a[2]),
                                    np.cos(b[2] - a[2]))])

    pairs = [(i, i + 1) for i in range(live - 1)]
    pairs += [(0, 23), (2, 20), (5, 17), (8, 14), (3, 11), (12, 21)]
    owner = [0] * len(pairs) + [1, 1]
    pairs += [(1, 9), (4, 16)]
    poses = np.zeros((n, 3), np.float32)
    poses[:live] = truth + np.concatenate(
        [rng.normal(0, 0.05, (live, 2)), rng.normal(0, 0.02, (live, 1))], 1)
    poses[0] = truth[0]
    ij = np.zeros((e, 2), np.int32)
    z = np.zeros((e, 3), np.float32)
    info = np.zeros((e, 6), np.float32)
    ij[:len(pairs)] = pairs
    for k, (a, b) in enumerate(pairs):
        z[k] = rel(truth[a], truth[b]) + np.r_[rng.normal(0, 0.01, 2),
                                                rng.normal(0, 0.005)]
    info[:len(pairs)] = [400.0, 0.0, 0.0, 400.0, 0.0, 2000.0]
    emask = np.zeros(e, bool)
    emask[:len(pairs)] = True
    e_owner = np.zeros(e, np.int32)
    e_owner[:len(pairs)] = owner
    vmask = np.arange(n) < live
    t = torch.as_tensor
    return G.PoseGraph(
        poses=t(poses), vmask=t(vmask), fixed=t(np.arange(n) == 0),
        e_ij=t(ij), e_z=t(z), e_info=t(info), emask=t(emask),
        e_level=t(np.zeros(e, np.int32)), e_owner=t(e_owner),
        n_vertices=t(np.int32(live)), n_edges=t(np.int32(len(pairs))))


def _merged_graph(seed: int = 3, k: int = 3):
    """Robot 0's merged view (capacity 1024, 896 edge slots) with pose
    noise N(0, 0.02 m), N(0, 0.006 rad), its (owner, keyframe) order and
    the ``k`` newest robot-0 vertices of its inter-robot closures."""
    z = dict(np.load(FIXTURE))
    rng = np.random.default_rng(seed)
    noise = np.concatenate([rng.normal(0, 0.02, (1024, 2)),
                            rng.normal(0, 0.006, (1024, 1))], 1)
    noise[~z["vmask"] | z["fixed"]] = 0
    f = {k: z[k][:896] for k in ("e_ij", "e_z", "e_info", "emask",
                                 "e_level", "e_owner")}
    g = G.PoseGraph(
        poses=torch.as_tensor((z["poses"] + noise).astype(np.float32)),
        vmask=torch.as_tensor(z["vmask"]), fixed=torch.as_tensor(z["fixed"]),
        **{k: torch.as_tensor(v) for k, v in f.items()},
        n_vertices=torch.as_tensor(z["n_vertices"]),
        n_edges=torch.as_tensor(z["n_edges"]))
    vo, vr = z["v_owner"], z["v_remote"]
    ij = f["e_ij"][f["emask"]]
    ends = np.unique(ij[vo[ij[:, 0]] != vo[ij[:, 1]]])
    mine = ends[vo[ends] == 0]
    boundary = mine[np.argsort(-vr[mine], kind="stable")][:k]
    order = chain_order(torch.as_tensor(vo), torch.as_tensor(vr),
                        g.vmask)
    return g, torch.as_tensor(boundary.astype(np.int32)), order


def _host(g: G.PoseGraph) -> dict:
    return {k: getattr(g, k).numpy() for k in ("poses", "vmask", "e_ij",
                                               "e_z", "e_info")}


def _rel_frob(a, b):
    return (np.linalg.norm(a - b, axis=(-2, -1))
            / np.linalg.norm(b, axis=(-2, -1)))


def _angle_gap(a, b):
    d = np.abs(a - b)
    d[..., 2] = np.abs((a[..., 2] - b[..., 2] + np.pi) % (2 * np.pi) - np.pi)
    return d


def _against_oracle(g, boundary, valid, order, rtol_u, tol_z, tol_info):
    own = G.own_edge_mask(g, 0)
    gn.BAND_CALLS.clear()
    star, u = CG.condense_optimal(g, boundary, valid, own, order)
    want_u, best, (wz, wom, wvalid) = oracle.optimal(
        _host(g), own.numpy(), boundary.numpy(), valid.numpy())
    u = u.double().numpy()
    assert np.all(np.isinf(u[~valid.numpy()]))
    np.testing.assert_allclose(u[valid.numpy()], want_u[valid.numpy()],
                               rtol=rtol_u)
    assert int(star.gauge) == int(boundary[best])
    np.testing.assert_array_equal(star.valid.numpy(), wvalid)
    ok = wvalid
    assert _angle_gap(star.z.double().numpy(), wz)[ok].max() <= tol_z
    om = G.unpack_info(star.info).double().numpy()
    assert _rel_frob(om, wom)[ok].max() <= tol_info
    return star, dict(gn.BAND_CALLS)


def test_condense_optimal_matches_oracle_dense_band():
    g = _small_graph()
    boundary = torch.tensor([3, 7, 12, 18, 22], dtype=torch.int32)
    valid = torch.tensor([True, True, False, True, True])
    _, bands = _against_oracle(g, boundary, valid, None, 1e-4, 1e-5, 1e-5)
    assert set(b for _, b in bands) == {"dense"}


@pytest.fixture(scope="module")
def merged():
    return _merged_graph()


def test_condense_optimal_matches_oracle_pcg_band(merged):
    g, boundary, order = merged
    valid = torch.ones(3, dtype=torch.bool)
    _, bands = _against_oracle(g, boundary, valid, order, 2e-5, 2e-5, 2e-5)
    assert bands == {("optimize_auto", "pcg"): 3,
                     ("marginal_covariance_auto", "pcg"): 3}


@pytest.mark.parametrize("valid", [[True] * 5, [True, False, True, True,
                                                 False]])
def test_winner_from_the_batch_is_a_fresh_condense(valid):
    g = _small_graph()
    boundary = torch.tensor([3, 7, 12, 18, 22], dtype=torch.int32)
    valid = torch.tensor(valid)
    own = G.own_edge_mask(g, 0)
    star, u = CG.condense_optimal(g, boundary, valid, own)
    assert int(star.gauge) == int(boundary[int(torch.argmin(u))])
    fresh = CG.condense(g, boundary, valid, star.gauge, own)
    assert torch.equal(star.valid, fresh.valid)
    assert torch.equal(star.boundary, fresh.boundary)
    ok = star.valid.numpy()
    assert _angle_gap(star.z.double().numpy(),
                      fresh.z.double().numpy())[ok].max() <= 1e-5
    assert _rel_frob(G.unpack_info(star.info).double().numpy(),
                     G.unpack_info(fresh.info).double().numpy()
                     )[ok].max() <= 1e-4


def test_no_valid_candidate_gives_an_empty_star():
    g = _small_graph()
    boundary = torch.tensor([3, 7], dtype=torch.int32)
    valid = torch.zeros(2, dtype=torch.bool)
    star, u = CG.condense_optimal(g, boundary, valid, G.own_edge_mask(g, 0))
    assert torch.isinf(u).all() and int(star.gauge) == 3
    assert not star.valid.any()


def _star_state(graph: G.PoseGraph, closed) -> MR.MRState:
    """An ``MRState`` of robot 0 holding ``graph`` (32 vertex, 96 edge
    slots), peer 1 having closed on the vertices ``closed``."""
    cfg = Config(mr=MRConfig(n_robots=2), max_vertices=32, max_edges=96,
                 max_beams=8)
    st = MR.init_mr_state(cfg, 8, [0.0, 0.0, 0.0],
                          np.full(8, 4.0, np.float32), np.pi, 5.0, my_id=0,
                          device="cpu")
    v_remote = torch.where(graph.vmask, torch.arange(32, dtype=torch.int32),
                           torch.full((32,), -1, dtype=torch.int32))
    in_c = torch.zeros((2, 32), dtype=torch.bool)
    in_c[1, closed] = True
    slam = dataclasses.replace(st.slam, graph=graph, v_remote=v_remote)
    return dataclasses.replace(st, slam=slam, in_closures=in_c)


def test_build_star_optimal_is_condense_optimal():
    st = _star_state(_small_graph(), [2, 7, 12, 18, 23])
    got = MR.build_star(st, 1, gauge_mode="optimal", cap=8)
    g, slots, valid, own, order, _ = MR.star_inputs(st, 1, 8)
    star, _ = CG.condense_optimal(g, slots, valid, own, order)
    assert int(got.gauge) == int(st.slam.v_remote[int(star.gauge)])
    assert torch.equal(got.z, star.z) and torch.equal(got.info, star.info)
    assert torch.equal(got.valid, star.valid)
    with pytest.raises(ValueError):
        MR.build_star(st, 1, gauge_mode="median", cap=8)


# -- the mode from the configuration to every star --------------------------


class _Seen(Exception):
    pass


@pytest.fixture
def spy(monkeypatch):
    """``mrslam.build_star`` replaced by a spy that records the gauge mode
    of its first call and stops the caller there."""
    seen = []

    def build_star(st, peer, gauge_mode="centroid", cap=MR.STAR_EDGES):
        seen.append(gauge_mode)
        raise _Seen

    monkeypatch.setattr(MR, "build_star", build_star)
    return seen


def _cfg(mode: str) -> Config:
    return Config(mr=MRConfig(n_robots=2, gauge_mode=mode), max_vertices=32,
                  max_edges=96, max_beams=8)


def _states(cfg):
    return [MR.init_mr_state(cfg, 8, [float(r), 0.0, 0.0],
                             np.full(8, 4.0, np.float32), np.pi, 5.0,
                             my_id=r, device="cpu") for r in range(2)]


@pytest.mark.parametrize("mode", ["centroid", "optimal"])
def test_the_mode_reaches_exchange(spy, mode):
    from cg_mrslam_tpu_torch.parallel import fleet

    cfg = _cfg(mode)
    with pytest.raises(_Seen):
        fleet.exchange(_states(cfg), np.ones((2, 2), bool), cfg)
    assert spy == [mode]


@pytest.mark.parametrize("mode", ["centroid", "optimal"])
def test_the_mode_reaches_multi_robot_sim(spy, mode):
    from cg_mrslam_tpu_torch.mr.sim import MultiRobotSim

    cfg = _cfg(mode)
    trajs = [types.SimpleNamespace(gt=np.zeros((4, 3)) + [r, 0.0, 0.0],
                                   ranges=np.full((4, 8), 4.0, np.float32))
             for r in range(2)]
    sim = MultiRobotSim(cfg, None, beams=8, max_range=5.0,
                        trajectories=trajs, device="cpu")
    with pytest.raises(_Seen):
        sim.exchange_round(1, "real")
    assert spy == [mode]


class _Quiet:
    """A transport that sends nowhere."""

    def send(self, peer, buf):
        pass

    def drain(self):
        return []

    def close(self):
        pass


@pytest.mark.parametrize("mode", ["centroid", "optimal"])
def test_the_mode_reaches_the_node(spy, mode):
    from cg_mrslam_tpu_torch.mr.node import RobotNode

    node = RobotNode(_cfg(mode), 0, 8, np.zeros(3),
                     np.full(8, 4.0, np.float32), np.pi, 5.0, _Quiet(),
                     device="cpu")
    in_c = node.state.in_closures.clone()
    in_c[1, 0] = True
    node.state = dataclasses.replace(node.state, in_closures=in_c)
    with pytest.raises(_Seen):
        node._star(1)
    assert spy == [mode]


def test_config_refuses_an_unknown_mode():
    assert MRConfig().gauge_mode == "centroid"
    with pytest.raises(ValueError):
        MRConfig(gauge_mode="median")


@pytest.mark.parametrize("argv,mode", [([], "centroid"),
                                       (["--gauge-mode", "optimal"],
                                        "optimal"),
                                       (["--gauge-mode", "centroid"],
                                        "centroid")])
def test_gauge_mode_flag(monkeypatch, argv, mode):
    """``cg_mrslam --gauge-mode`` sets the configuration of the in-process
    run and of one robot per process (``--idRobot``)."""
    from cg_mrslam_tpu_torch.mr import node as node_mod
    from cg_mrslam_tpu_torch.mr import sim as sim_mod
    from cg_mrslam_tpu_torch.mr import transport
    from cg_mrslam_tpu_torch.sim import world as W

    seen = []

    def capture(cfg, *a, **k):
        seen.append(cfg.mr.gauge_mode)
        raise _Seen

    monkeypatch.setattr(sim_mod, "MultiRobotSim", capture)
    monkeypatch.setattr(node_mod, "RobotNode", capture)
    monkeypatch.setattr(transport, "UdpTransport", lambda *a, **k: _Quiet())
    monkeypatch.setattr(W, "hospital_world", lambda *a, **k: None)
    monkeypatch.setattr(W, "simulate_robot", lambda *a, **k: (
        types.SimpleNamespace(gt=np.zeros((2, 3)),
                              ranges=np.zeros((2, 8)))))
    for extra in ([], ["--idRobot", "1"]):
        with pytest.raises(_Seen):
            cli.main(["cg_mrslam"] + argv + extra, device="cpu")
    assert seen == [mode, mode]
    with pytest.raises(SystemExit):
        cli.main(["cg_mrslam", "--gauge-mode", "median"], device="cpu")


# -- spans and counters -------------------------------------------------------


def test_one_optimal_star_records_its_spans_and_counters(merged):
    g, boundary, order = merged
    valid = torch.tensor([True, False, True])
    own = G.own_edge_mask(g, 0)
    M.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        CG.condense_optimal(g, boundary, valid, own, order)
    spans, counts = M.span_totals(), M.counts()
    under_marginals = M.span_totals(under="condense.marginals")
    M.reset()
    for name in ("star.optimal", "condense.settle", "condense.marginals",
                 "condense.label", "marginal.hvp", "marginal.precond_apply",
                 "marginal.update", "marginal.pcg"):
        assert name in spans, name
    assert spans["star.optimal"]["calls"] == 1
    assert spans["condense.marginals"]["calls"] == 1
    # the batched marginal call runs under its own span, not band.pcg
    assert "band.pcg" not in under_marginals
    assert "marginal.pcg" in under_marginals
    assert spans["marginal.hvp"]["calls"] == counts["loop.pcg.marginal.iters"]
    assert spans["marginal.update"]["calls"] \
        == 2 * counts["loop.pcg.marginal.iters"]
    assert counts["condense.graphs"] == 2
    assert counts["condense.columns"] == 2 * 3 * 3
    assert counts["host_read.gauge_candidates"] == 1
