"""The chain-preconditioned PCG band at capacity 1024: the port's solve of
the committed merged two-robot snapshot
(``tests/fixtures/merged_2robot_1024.npz``, 1020 live vertices, 334
inter-robot closures, not chainable) against the JAX package's solve of
the same graph, loaded as ``tests/test_merged_parity.py:_load`` loads it.

Both run what ``test_merged_parity.py`` runs: ``optimize_pcg`` one GN
iteration at a time (96 CG iterations each) under the (owner, keyframe)
permutation, five times. Bars: every iteration's chi2 within 1% of the
reference's (BASELINE's bar, the one ``test_merged_parity.py`` holds
against its float64 oracle), and the final poses within 1e-4 m / rad of
the reference's (two float32 CG solves of a 3072-unknown system that sum
in different orders, stopped at the same budget; 2.1e-5 apart on the CPU,
the chi2s 6e-7 apart relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_mrslam_tpu.core.linearize import chi2 as jchi2
from cg_mrslam_tpu.solver.chain import chain_order as jchain_order
from cg_mrslam_tpu.solver.pcg import optimize_pcg as joptimize_pcg
from cg_mrslam_tpu_torch.core.graph import PoseGraph
from cg_mrslam_tpu_torch.core.linearize import chi2 as tchi2
from cg_mrslam_tpu_torch.solver.chain import chain_order as tchain_order
from cg_mrslam_tpu_torch.solver.pcg import optimize_pcg as toptimize_pcg
from test_merged_parity import _load
from torch_port_helpers import port, tf

torch.set_num_threads(1)

ITERS, CG_ITERS = 5, 96


@pytest.fixture(scope="module")
def solves():
    z, jg = _load()
    jorder = jchain_order(jnp.asarray(z["v_owner"]),
                          jnp.asarray(z["v_remote"]), jnp.asarray(z["vmask"]))
    step = jax.jit(lambda gg: joptimize_pcg(gg, iterations=1,
                                            cg_iters=CG_ITERS, order=jorder))
    tg = port(jg, PoseGraph)
    torder = tchain_order(tf(z["v_owner"]), tf(z["v_remote"]),
                          torch.as_tensor(z["vmask"]))
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    jchis, tchis = [float(jchi2(jg))], [float(tchi2(tg))]
    for _ in range(ITERS):
        jg = step(jg)
        tg = toptimize_pcg(tg, iterations=1, cg_iters=CG_ITERS, order=torder)
        jchis.append(float(jchi2(jg)))
        tchis.append(float(tchi2(tg)))
    return z, jg, tg, jchis, tchis


def test_merged_pcg_tracks_reference_per_iteration(solves):
    z, _, _, jchis, tchis = solves
    assert int(z["n_vertices"]) > 1000
    assert tchis[0] == pytest.approx(jchis[0], rel=1e-5)
    for k, (got, want) in enumerate(zip(tchis[1:], jchis[1:])):
        assert abs(got - want) <= 0.01 * want, (k, tchis, jchis)
    assert tchis[-1] < tchis[0], tchis
    # the final basin of test_merged_parity.py's dense float64 oracle
    assert abs(tchis[-1] - 12.796) < 0.13, tchis


def test_merged_pcg_final_poses(solves):
    _, jg, tg, _, _ = solves
    d = tg.poses.numpy().astype(np.float64) - np.asarray(jg.poses)
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(d).max() <= 1e-4, np.abs(d).max()
