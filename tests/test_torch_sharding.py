"""Parity of the port's edge-sharded batched solves
(``parallel/sharding.py``) with ``cg_mrslam_tpu.parallel.sharding``'s
single-device references, as real multi-process programs: four gloo
processes on a 2 × 2 (``graphs`` × ``shard``) mesh, on the batches of
noisy loop graphs that ``__graft_entry__._build_batch`` builds.

Bars, as ``tests/test_sharding.py`` holds the reference's own sharded
solves: the dense solve within 5e-3 of ``vmap(gauss_newton.optimize)``
(which solves by an SPD inverse and a CG polish where the sharded solve
factorizes, and sums in another order; GN iterations amplify the drift,
angles compared modulo 2π), the uneven edge shards within 5e-4 after 3
iterations, and the matrix-free solve within 5e-3 of
``vmap(pcg.optimize_pcg)`` (block-Jacobi against the reference's
tridiagonal preconditioner at the same CG budget).
"""

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_batch
from cg_mrslam_tpu.solver import gauss_newton as gn
from cg_mrslam_tpu.solver import pcg as PCG
from cg_mrslam_tpu_torch import convert
from cg_mrslam_tpu_torch.parallel import sharding as SH
from cg_mrslam_tpu_torch.parallel.launch import run_group
import torch_dist_workers as workers

torch.set_num_threads(1)

GROUP_TIMEOUT = 120.0


def _wrapped(d: np.ndarray) -> np.ndarray:
    d = d.copy()
    d[..., 2] = (d[..., 2] + np.pi) % (2 * np.pi) - np.pi
    return d


def _solve(tmp_path, g, shard, kind, iterations, cg_iters=64):
    res = run_group(workers.sharded_solve, 4,
                    args=(convert.to_numpy(g), shard, kind, iterations,
                          cg_iters),
                    workdir=tmp_path, timeout=GROUP_TIMEOUT)
    for r in res[1:]:      # every rank gathers the same batch
        np.testing.assert_array_equal(r, res[0])
    return res[0]


def test_sharded_matches_single_device(tmp_path):
    g = _build_batch(8)
    poses = _solve(tmp_path, g, 2, "dense", 5)
    ref = jax.vmap(lambda gg: gn.optimize(gg, iterations=5))(g)
    d = _wrapped(poses - np.asarray(ref.poses))
    assert np.abs(d).max() < 5e-3, np.abs(d).max()


@pytest.mark.parametrize("shard", [2, 4])
def test_sharded_handles_uneven_edge_shards(tmp_path, shard):
    """130 edges: 65 a shard on the 2 × 2 mesh; on a 1 × 4 mesh the shards
    are padded to 33 with masked slots."""
    g = _build_batch(4, n_vertices=64, n_edges=130)
    poses = _solve(tmp_path, g, shard, "dense", 3)
    ref = jax.vmap(lambda gg: gn.optimize(gg, iterations=3))(g)
    np.testing.assert_allclose(poses, np.asarray(ref.poses), atol=5e-4)


def test_sharded_pcg_matches_single_device(tmp_path):
    g = _build_batch(8)
    poses = _solve(tmp_path, g, 2, "pcg", 3, cg_iters=48)
    ref = jax.vmap(lambda gg: PCG.optimize_pcg(gg, iterations=3,
                                               cg_iters=48))(g)
    d = _wrapped(poses - np.asarray(ref.poses))
    assert np.abs(d).max() < 5e-3, np.abs(d).max()


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no torch.distributed process"):
        SH.make_mesh(4, shard=2, device_type="cpu")


def test_build_batch_matches_reference():
    from cg_mrslam_tpu_torch.sim.graphs import build_batch

    for args in ((8,), (4, 64, 130)):
        got = convert.to_numpy(build_batch(*args, device="cpu"))
        want = convert.to_numpy(_build_batch(*args))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
