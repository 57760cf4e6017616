"""Parity of the port's dense Cholesky band (``solver/gauss_newton.py``)
with ``cg_mrslam_tpu`` run in float32, on the committed parity fixtures.

Tolerances and why:

* The fixture tests' own bars (``test_parity_fixtures.py``) are float64;
  here both sides are float32 and the port assembles H by scatter
  (``index_add_``) where the reference uses one-hot matmuls, so sums run in
  another order. Assembly: rtol 1e-5 with an absolute floor of 1e-5 of
  the largest entry (H spans ~1e-3..1e5).
* chi2 after each GN iteration: rtol 1e-3 against the float32 reference —
  float32 Cholesky on these Hessians (κ up to ~1e6) leaves relative
  update errors near 1e-4, which chi2 (quadratic in the residual) carries
  at that order; and within 1% of the float64 oracle
  (``fixtures/expected_chi2.json``), the reference's own bar.
* Marginal covariances: rtol 1e-3, absolute floor 1e-4 of the largest
  entry, for the same float32 conditioning reason.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_mrslam_tpu.core.linearize import chi2 as jchi2
from cg_mrslam_tpu.io import g2o
from cg_mrslam_tpu.solver import gauss_newton as jgn
from cg_mrslam_tpu_torch.core import graph as TG
from cg_mrslam_tpu_torch.core.linearize import chi2 as tchi2
from cg_mrslam_tpu_torch.solver import gauss_newton as tgn
from torch_port_helpers import CPU, npy, port

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
EXPECTED = json.load(open(os.path.join(FIXDIR, "expected_chi2.json")))
NAMES = sorted(EXPECTED)


def _load(name):
    jg = g2o.load(os.path.join(FIXDIR, f"{name}.g2o"),
                  dtype=jnp.float32).graph
    return jg, port(jg, TG.PoseGraph)


def _close(got, want, rtol, floor):
    got, want = npy(got), npy(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * np.abs(want).max())


@pytest.mark.parametrize("name", NAMES)
def test_normal_equations(name):
    jg, tg = _load(name)
    je = jgn.build_normal_equations(jg)
    te = tgn.build_normal_equations(tg)
    _close(te.H, je.H, 1e-5, 1e-5)
    _close(te.b, je.b, 1e-5, 1e-5)
    np.testing.assert_array_equal(npy(te.free3), npy(je.free3))


@pytest.mark.parametrize("name", NAMES)
def test_gn_chi2_per_iteration(name):
    jg, tg = _load(name)
    np.testing.assert_allclose(float(tchi2(tg)), float(jchi2(jg)), rtol=1e-5)
    for k, oracle in enumerate(EXPECTED[name]["raw"]):
        jg = jgn.optimize(jg, 1, chol=True)
        tg = tgn.optimize(tg, 1)
        got, want = float(tchi2(tg)), float(jchi2(jg))
        assert abs(got - want) <= 1e-3 * abs(want), (name, k, got, want)
        assert abs(got - oracle) <= 0.01 * abs(oracle), (name, k, got,
                                                         oracle)
    np.testing.assert_allclose(npy(tg.poses), npy(jg.poses), atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_marginal_covariance(name):
    jg, tg = _load(name)
    n = int(jg.n_vertices)
    q = np.array([1, n // 3, n // 2, n - 1], np.int32)
    want = jgn.marginal_covariance(jg, jnp.asarray(q), chol=True)
    got = tgn.marginal_covariance(tg, torch.as_tensor(q))
    assert got.shape == (4, 3, 3)
    _close(got, want, 1e-3, 1e-4)
    via_auto = tgn.marginal_covariance_auto(tg, torch.as_tensor(q))
    np.testing.assert_array_equal(npy(via_auto), npy(got))


def test_cholesky_nan_on_indefinite():
    """A matrix that is not positive definite gives NaN (as
    ``cho_factor`` does), not an exception."""
    h = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    assert torch.isnan(tgn._cholesky(h)).all()


def test_bands():
    """Up to DENSE_MAX_CHOL the auto entry points are the dense band;
    above it they raise — the chain/PCG band is a later slice."""
    assert (tgn.DENSE_MAX, tgn.DENSE_MAX_CHOL, tgn.PCG_MIN) == (
        jgn.DENSE_MAX, jgn.DENSE_MAX_CHOL, jgn.PCG_MIN)
    _, tg = _load("ring60")
    a = tgn.optimize_auto(tg, 2)
    b = tgn.optimize(tg, 2)
    np.testing.assert_array_equal(npy(a.poses), npy(b.poses))
    assert int(tgn.auto_backend(tg)) == 0
    big = TG.empty(tgn.DENSE_MAX_CHOL + 1, 8, CPU)
    with pytest.raises(NotImplementedError, match="later slice"):
        tgn.optimize_auto(big, 1)
    with pytest.raises(NotImplementedError, match="later slice"):
        tgn.marginal_covariance_auto(big, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        tgn.auto_backend(big)
