"""Parity of the port's solver bands (``solver/spd.py``, ``chain.py``,
``pcg.py`` and the banded entry points of ``gauss_newton.py``) with
``cg_mrslam_tpu``, on the same float32 graphs made from a seed with numpy.

Tolerances and why:

* ``spd_inverse``: both sides run the same recursion and Newton–Schulz
  polish in float32, but torch and XLA sum the matmuls in other orders; at
  κ = 100 both land within 1e-5 of the largest entry of the exact inverse,
  so the bar is relative 1e-4. (At κ = 1e3 and n = 12 both sides' polish
  reaches the float32 floor above its 1e-4 tolerance, takes that for
  divergence and restarts, and both return an inverse off by 0.3–0.5:
  the reference's own behaviour, not a port fault.) ``pcg_refine``
  solves agree with numpy's float64 solve to the reference's own bar (10× the float32 Cholesky error).
* ``chain_order`` and ``chainable`` are integer and boolean: exact.
* Chain and PCG updates: CG on float32 data converges to the solver
  tolerance from either side, so poses agree to 1e-3 (the reference's
  chain-vs-dense bar, ``tests/test_chain_solver.py``) and chi2 to rtol 1e-2
  with an absolute floor of 1e-3 (chi2 is quadratic in the residual; at
  convergence it sits near the float32 noise floor).
* Marginals: relative 1e-2 of the largest entry, the CG column tolerance
  (1e-5 on the unit column) amplified by κ.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_mrslam_tpu.core import graph as JG
from cg_mrslam_tpu.core.linearize import chi2 as jchi2
from cg_mrslam_tpu.solver import chain as JCH
from cg_mrslam_tpu.solver import gauss_newton as jgn
from cg_mrslam_tpu.solver import pcg as JPCG
from cg_mrslam_tpu.solver import spd as JSPD
from cg_mrslam_tpu_torch.core import graph as TG
from cg_mrslam_tpu_torch.core.linearize import chi2 as tchi2
from cg_mrslam_tpu_torch.solver import chain as TCH
from cg_mrslam_tpu_torch.solver import cyclic_reduction as TCR
from cg_mrslam_tpu_torch.solver import gauss_newton as tgn
from cg_mrslam_tpu_torch.solver import pcg as TPCG
from cg_mrslam_tpu_torch.solver import spd as TSPD
from torch_port_helpers import jf, npy, port, tf

torch.set_num_threads(1)


def _spd(rng, b, n, cond=1e3):
    q, _ = np.linalg.qr(rng.normal(size=(b, n, n)))
    ev = np.exp(rng.uniform(0, np.log(cond), size=(b, n)))
    return ((q * ev[:, None, :]) @ np.swapaxes(q, -1, -2))


def _rel(a, b):
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    t = (b[..., 2] - a[..., 2] + np.pi) % (2 * np.pi) - np.pi
    return np.stack([c * dx + s * dy, -s * dx + c * dy, t], -1)


def _graph(edges, gt, est, cap_v, cap_e, fixed=(0,)):
    """Both packages' PoseGraph from numpy: vertices ``est`` in slots
    ``0..n-1``, edges ``[(i, j, owner, level)]`` measured on ``gt``."""
    n = len(est)
    poses = np.zeros((cap_v, 3), np.float32)
    poses[:n] = est
    vmask = np.zeros(cap_v, bool)
    vmask[:n] = True
    fx = np.zeros(cap_v, bool)
    fx[list(fixed)] = True
    e_ij = np.zeros((cap_e, 2), np.int32)
    e_z = np.zeros((cap_e, 3), np.float32)
    e_info = np.zeros((cap_e, 6), np.float32)
    emask = np.zeros(cap_e, bool)
    e_level = np.zeros(cap_e, np.int32)
    e_owner = np.zeros(cap_e, np.int32)
    for k, (i, j, owner, level) in enumerate(edges):
        e_ij[k] = (i, j)
        e_z[k] = _rel(gt[i], gt[j])
        e_info[k] = (100.0, 10.0, 0.0, 100.0, 0.0, 1000.0)
        emask[k] = True
        e_owner[k] = owner
        e_level[k] = level
    jg = JG.PoseGraph(
        poses=jf(poses), vmask=jnp.asarray(vmask), fixed=jnp.asarray(fx),
        e_ij=jf(e_ij), e_z=jf(e_z), e_info=jf(e_info),
        emask=jnp.asarray(emask), e_level=jf(e_level), e_owner=jf(e_owner),
        n_vertices=jnp.int32(n), n_edges=jnp.int32(len(edges)))
    return jg, port(jg, TG.PoseGraph)


def _ring(n, seed):
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.stack([8 * np.cos(th), 8 * np.sin(th), th + np.pi / 2], 1)
    est = gt + np.concatenate([rng.normal(0, 0.2, (n, 2)),
                               rng.normal(0, 0.05, (n, 1))], 1)
    est[0] = gt[0]
    return rng, gt, est


def _loop_graph(n=50, closures=5, seed=0, cap_v=64, cap_e=128):
    """A noisy ring: odometry chain plus a few loop closures
    (``tests/test_chain_solver.py``'s graph)."""
    rng, gt, est = _ring(n, seed)
    edges = [(k, k + 1, 0, 0) for k in range(n - 1)]
    for _ in range(closures):
        i = int(rng.integers(0, n - 1))
        j = (i + n // 2) % n
        i, j = min(i, j), max(i, j)
        if j != i + 1:
            edges.append((i, j, 0, 0))
    return _graph(edges, gt, est, cap_v, cap_e)


def _merged_graph(n_each=60, seed=3, cap_v=300, cap_e=600):
    """Two robots' chains interleaved in slot order (foreign vertices
    arrive between own keyframes), with inter-robot closures: the merged
    multi-robot shape that needs the chain permutation. Returns both
    graphs and ``(v_owner, v_remote)``."""
    rng = np.random.default_rng(seed)
    n = 2 * n_each
    th = np.linspace(0, 2 * np.pi, n_each, endpoint=False)
    gt_r = [np.stack([8 * np.cos(th) + 3 * r, 8 * np.sin(th),
                      th + np.pi / 2], 1) for r in range(2)]
    owner = np.zeros(n, np.int32)
    remote = np.zeros(n, np.int32)
    owner[1::2] = 1
    remote[0::2] = np.arange(n_each)
    remote[1::2] = np.arange(n_each)
    gt = np.zeros((n, 3))
    gt[0::2], gt[1::2] = gt_r[0], gt_r[1]
    est = gt + np.concatenate([rng.normal(0, 0.1, (n, 2)),
                               rng.normal(0, 0.03, (n, 1))], 1)
    est[0] = gt[0]
    edges = [(2 * k, 2 * k + 2, 0, 0) for k in range(n_each - 1)]
    edges += [(2 * k + 1, 2 * k + 3, 1, 1) for k in range(n_each - 1)]
    for k in range(0, n_each, 7):
        edges.append((2 * k, 2 * ((k + 3) % n_each) + 1, 0, 0))
    jg, tg = _graph(edges, gt, est, cap_v, cap_e, fixed=(0,))
    vo = np.zeros(cap_v, np.int32)
    vr = np.full(cap_v, -1, np.int32)
    vo[:n], vr[:n] = owner, remote
    return jg, tg, vo, vr


def _close(got, want, rtol, floor):
    got, want = npy(got).astype(np.float64), npy(want).astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * np.abs(want).max())


def _poses_close(tg, jg, atol):
    d = npy(tg.poses).astype(np.float64) - npy(jg.poses)
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
    np.testing.assert_allclose(d, 0.0, atol=atol)


def _chi2_close(tg, jg, mask=None):
    t = float(tchi2(tg, None if mask is None else tf(mask)))
    j = float(jchi2(jg, None if mask is None else jnp.asarray(mask)))
    assert abs(t - j) <= 1e-2 * abs(j) + 1e-3, (t, j)
    return t, j


@pytest.mark.parametrize("n", [12, 48, 75, 192])
def test_spd_inverse(n):
    rng = np.random.default_rng(n)
    h = _spd(rng, 3, n, cond=100.0).astype(np.float32)
    got = npy(TSPD.spd_inverse(tf(h)))
    want = npy(JSPD.spd_inverse(jf(h)))
    _close(got, want, 1e-4, 1e-4)
    exact = np.linalg.inv(h.astype(np.float64))
    assert np.abs(got - exact).max() / np.abs(exact).max() < 1e-4


def test_pcg_refine():
    """The production pairing (SPD inverse → CG polish) at κ = 1e5, and a
    deliberately poor preconditioner that CG must rescue
    (``tests/test_spd.py``'s cases)."""
    rng = np.random.default_rng(1)
    h64 = _spd(rng, 4, 192, cond=1e5)
    b64 = rng.normal(size=(4, 192, 2))
    h, b = h64.astype(np.float32), b64.astype(np.float32)
    want = np.linalg.solve(h64, b64)
    got = npy(TSPD.pcg_refine(tf(h), tf(b), TSPD.spd_inverse(tf(h))))
    ref = np.asarray(JSPD.pcg_refine(jf(h), jf(b), JSPD.spd_inverse(jf(h))))
    err = np.abs(got - want).max() / np.abs(want).max()
    err_ref = np.abs(ref - want).max() / np.abs(want).max()
    chol = np.linalg.solve(h.astype(np.float32), b)   # float32 LAPACK
    err_chol = np.abs(chol - want).max() / np.abs(want).max()
    assert err < 10 * err_chol + 1e-6, (err, err_chol)
    assert err < 10 * err_ref + 1e-6, (err, err_ref)
    h64 = _spd(rng, 2, 96, cond=1e4)
    h = h64.astype(np.float32)
    b = rng.normal(size=(2, 96, 2)).astype(np.float32)
    want = np.linalg.solve(h64, b.astype(np.float64))
    minv = np.broadcast_to(0.01 * np.eye(96, dtype=np.float32), h.shape)
    got = npy(TSPD.pcg_refine(tf(h), tf(b), tf(minv), max_iters=256,
                              tol=1e-6))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-2


def test_chain_order_and_permutation():
    """Dead slots share one key and keep slot order (stable sort)."""
    rng = np.random.default_rng(0)
    n = 96
    vo = rng.integers(0, 3, n).astype(np.int32)
    vr = rng.permutation(n).astype(np.int32)
    vm = rng.uniform(size=n) > 0.3
    want = np.asarray(JCH.chain_order(jf(vo), jf(vr), jnp.asarray(vm)))
    got = npy(TCH.chain_order(tf(vo), tf(vr), torch.as_tensor(vm)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(npy(TG.inverse_permutation(tf(want))),
                                  np.asarray(JG.inverse_permutation(
                                      jf(want))))
    jg, tg = _loop_graph()
    order = rng.permutation(64).astype(np.int32)
    a = JG.permute_vertices(jg, jf(order))
    b = TG.permute_vertices(tg, tf(order))
    for f in ("poses", "vmask", "fixed", "e_ij"):
        np.testing.assert_array_equal(npy(getattr(b, f)),
                                      np.asarray(getattr(a, f)), err_msg=f)
    kill = rng.uniform(size=128) > 0.8
    np.testing.assert_array_equal(
        npy(TG.remove_edges(tg, torch.as_tensor(kill)).emask),
        np.asarray(JG.remove_edges(jg, jnp.asarray(kill)).emask))
    for inc in (True, False):
        np.testing.assert_array_equal(
            npy(TG.active_edge_mask(tg, inc)),
            np.asarray(JG.active_edge_mask(jg, inc)))
    np.testing.assert_array_equal(npy(TG.own_edge_mask(tg, 0)),
                                  np.asarray(JG.own_edge_mask(jg, 0)))


def test_chainable():
    jg, tg = _loop_graph()
    for cap in (None, 16, 1):
        assert bool(TCH.chainable(tg, loop_cap=cap)) == bool(
            JCH.chainable(jg, loop_cap=cap)), cap
    assert bool(TCH.chainable(tg, loop_cap=16))
    assert not bool(TCH.chainable(tg, loop_cap=1))
    # a vertex held only by a loop edge beyond the cap disqualifies
    rng, gt, est = _ring(50, 0)
    edges = [(k, k + 1, 0, 0) for k in range(49) if k not in (24, 25)]
    edges += [(2, 8, 0, 0), (12, 18, 0, 0), (5, 25, 0, 0)]
    jg2, tg2 = _graph(edges, gt, est, 64, 128)
    for cap in (3, 2):
        assert bool(TCH.chainable(tg2, loop_cap=cap)) == bool(
            JCH.chainable(jg2, loop_cap=cap)) == (cap == 3)
    jm, tm, vo, vr = _merged_graph()
    jo = JCH.chain_order(jf(vo), jf(vr), jm.vmask)
    to = TCH.chain_order(tf(vo), tf(vr), tm.vmask)
    assert not bool(TCH.chainable(tm, loop_cap=64))
    assert bool(TCH.chainable(tm, loop_cap=64, order=to))
    assert bool(JCH.chainable(jm, loop_cap=64, order=jo))


def test_cr_solve_and_chain_delta():
    rng = np.random.default_rng(4)
    n = 70
    d = _spd(rng, n, 3, cond=10.0) + 4 * np.eye(3)
    low = 0.3 * rng.normal(size=(n, 3, 3))
    low[-1] = 0
    rhs = rng.normal(size=(n, 3, 2))
    got = npy(TCR.cr_solve(tf(d), tf(low), tf(rhs)))
    want = np.asarray(JCH._cr_solve(jf(d), jf(low), jf(rhs)))
    _close(got, want, 1e-4, 1e-5)
    jg, tg = _loop_graph()
    tdx, tdrop = TCH.chain_delta(tg, loop_cap=16)
    jdx, jdrop = JCH.chain_delta(jg, loop_cap=16)
    assert int(tdrop) == int(jdrop) == 0
    _close(tdx, jdx, 5e-3, 5e-4)


@pytest.mark.parametrize("merged", [False, True])
def test_optimize_and_marginals_chain(merged):
    if merged:
        jg, tg, vo, vr = _merged_graph()
        jo = JCH.chain_order(jf(vo), jf(vr), jg.vmask)
        to = tf(np.asarray(jo))
        q = np.array([3, 40, 77, 118], np.int32)
    else:
        jg, tg = _loop_graph()
        jo = to = None
        q = np.array([5, 20, 33, 49], np.int32)
    jr = JCH.optimize_chain(jg, iterations=3, loop_cap=32, order=jo)
    tr = TCH.optimize_chain(tg, iterations=3, loop_cap=32, order=to)
    _poses_close(tr, jr, 1e-3)
    t, j = _chi2_close(tr, jr)
    assert t < float(tchi2(tg))
    want = JCH.marginal_covariance_chain(jr, jf(q), loop_cap=32, order=jo)
    got = TCH.marginal_covariance_chain(port(jr, TG.PoseGraph), tf(q),
                                        loop_cap=32, order=to)
    _close(got, want, 1e-2, 1e-2)


@pytest.mark.parametrize("merged", [False, True])
def test_optimize_and_marginals_pcg(merged):
    if merged:
        jg, tg, vo, vr = _merged_graph()
        jo = JCH.chain_order(jf(vo), jf(vr), jg.vmask)
        to = tf(np.asarray(jo))
    else:
        jg, tg = _loop_graph()
        jo = to = None
    jr = JPCG.optimize_pcg(jg, iterations=3, cg_iters=64, order=jo)
    tr = TPCG.optimize_pcg(tg, iterations=3, cg_iters=64, order=to)
    _poses_close(tr, jr, 1e-3)
    _chi2_close(tr, jr)
    q = np.array([0, 7, 21, 40], np.int32)   # 0 is fixed: identity block
    want = JPCG.marginal_covariance_pcg(jr, jf(q), cg_iters=96, order=jo)
    got = TPCG.marginal_covariance_pcg(port(jr, TG.PoseGraph), tf(q),
                                       cg_iters=96, order=to)
    _close(got, want, 1e-2, 1e-2)
    np.testing.assert_array_equal(npy(got)[0], np.eye(3))


@pytest.mark.parametrize("chainable", [True, False])
def test_optimize_auto_above_dense_max(chainable):
    """Capacity 300 > DENSE_MAX with ``chol=False``: the reference's
    backend choice (chain where chainable under the order, PCG where the
    loop edges overflow ``loop_cap``), and the same optimum."""
    jg, tg, vo, vr = _merged_graph()
    jo = JCH.chain_order(jf(vo), jf(vr), jg.vmask)
    to = tf(np.asarray(jo))
    cap = 64 if chainable else 4
    jb = int(jgn.auto_backend(jg, loop_cap=cap, order=jo))
    tb = int(tgn.auto_backend(tg, loop_cap=cap, order=to))
    assert tb == jb == (1 if chainable else 2)
    jr = jgn.optimize_auto(jg, 2, loop_cap=cap, order=jo)
    tr = tgn.optimize_auto(tg, 2, loop_cap=cap, order=to)
    t, j = _chi2_close(tr, jr)
    assert t < 0.1 * float(tchi2(tg))
    q = np.array([4, 9, 100], np.int32)
    want = jgn.marginal_covariance_auto(jr, jf(q), loop_cap=cap, order=jo)
    got = tgn.marginal_covariance_auto(port(jr, TG.PoseGraph), tf(q),
                                       loop_cap=cap, order=to)
    _close(got, want, 1e-2, 1e-2)


def test_dense_spd_band():
    """Up to DENSE_MAX, ``chol=False`` is the SPD inverse + CG polish."""
    jg, tg = _loop_graph()
    jr = jgn.optimize_auto(jg, 3)
    tr = tgn.optimize_auto(tg, 3)
    assert int(tgn.auto_backend(tg)) == int(jgn.auto_backend(jg)) == 0
    _poses_close(tr, jr, 1e-3)
    _chi2_close(tr, jr)
    q = np.array([3, 30], np.int32)
    _close(tgn.marginal_covariance(tr, tf(q)),
           jgn.marginal_covariance(jr, jf(q)), 1e-2, 1e-3)
    gm = dataclasses.replace(tg, fixed=torch.zeros_like(tg.fixed))
    assert torch.isfinite(tgn.optimize(gm, 1).poses).all()


def test_optimize_chain_counts_dropped_loops():
    """Loop edges past ``loop_cap`` stay out of the Woodbury term and are
    counted (``return_dropped``); CG on the true H still converges."""
    jg, tg = _loop_graph(closures=8, seed=2)
    jr, jd = JCH.optimize_chain(jg, iterations=2, loop_cap=2,
                                return_dropped=True)
    tr, td = TCH.optimize_chain(tg, iterations=2, loop_cap=2,
                                return_dropped=True)
    assert int(td) == int(jd) > 0
    _poses_close(tr, jr, 1e-3)
    _chi2_close(tr, jr)
