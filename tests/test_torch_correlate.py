"""Parity of the port's score volume (kernel K1's plain version,
``matcher/search.py:score_volume`` over ``ops/correlate.py``) with the
reference's XLA ``score_volume`` and its Pallas kernel in interpret mode,
on the cases of ``tests/test_pallas_correlate.py`` that apply to K1, at
its tolerance (rtol 1e-5, atol 1e-6). The CUDA kernel itself is held to
the plain version on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_mrslam_tpu.matcher.grid import build_grid as jbuild_grid
from cg_mrslam_tpu.matcher.search import make_lattice as jmake_lattice
from cg_mrslam_tpu.matcher.search import score_volume as jscore_volume
from cg_mrslam_tpu.ops.correlate import pallas_score_volume
from cg_mrslam_tpu_torch.ops import correlate as K
from cg_mrslam_tpu_torch.matcher import search as TS
from torch_port_helpers import jf, npy, tf

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _setup(seed=0, n_ref=200, n_mov=150, cells=160, res=0.05):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-3, 3, size=(n_ref, 2)).astype(np.float32)
    grid = np.asarray(jbuild_grid(jf(ref), jnp.ones(n_ref, bool),
                                  jnp.zeros(2, jnp.float32), cells=cells,
                                  resolution=res, kernel_radius=0.2),
                      np.float32)
    mov = rng.uniform(-3, 3, size=(n_mov, 2)).astype(np.float32)
    valid = np.ones(n_mov, bool)
    valid[-20:] = False  # exercise the invalid-beam path
    return grid, np.zeros(2, np.float32), res, mov, valid


def _both(grid, center, res, mov, valid, base, th_span, th_res, ry, rx):
    thetas = np.asarray(jmake_lattice(th_span, th_res), np.float32)
    ty = np.arange(-ry, ry + 1, dtype=np.int32)
    tx = np.arange(-rx, rx + 1, dtype=np.int32)
    base = np.asarray(base, np.float32)
    ja = [jf(x) for x in (grid, center)] + [res] + [
        jf(mov), jnp.asarray(valid), jf(base), jf(thetas), jf(ty), jf(tx)]
    xla = np.asarray(jscore_volume(*ja))
    pallas = np.asarray(pallas_score_volume(*ja, interpret=True))
    got = TS.score_volume(tf(grid), tf(center), res, tf(mov),
                          torch.as_tensor(valid), tf(base), tf(thetas),
                          tf(ty), tf(tx))
    assert got.shape == xla.shape and got.dtype == torch.float32
    return npy(got), xla, pallas


@pytest.mark.parametrize("base", [(0.0, 0.0, 0.0), (0.4, -0.3, 0.7)])
def test_matches_reference(base):
    got, xla, pallas = _both(*_setup(), base, 0.2, 0.05, 6, 4)
    np.testing.assert_allclose(got, xla, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)


def test_out_of_grid_points_contribute_zero():
    # every point lands out of grid → exact 0 (skipped from the sum, kept
    # in the normalization)
    got, xla, pallas = _both(*_setup(), (500.0, -500.0, 1.0), 0.1, 0.05, 3,
                             3)
    assert np.max(np.abs(got)) == 0.0
    np.testing.assert_allclose(got, xla, atol=1e-7)
    np.testing.assert_allclose(got, pallas, atol=1e-7)


def test_boundary_straddling_patch():
    grid, center, res, _, _ = _setup()
    edge = 160 * 0.05 / 2  # world half-extent
    mov = np.array([[edge - 0.02, 0.0], [-edge + 0.02, -edge + 0.02],
                    [0.0, edge + 0.1]], np.float32)
    got, xla, pallas = _both(grid, center, res, mov, np.ones(3, bool),
                             (0.0, 0.0, 0.0), 0.05, 0.05, 5, 5)
    np.testing.assert_allclose(got, xla, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("base", [(0.0, 0.0, 0.0), (0.4, -0.3, 0.7)])
def test_tall_lc_window(base):
    """The LC window shape (31 × 11), which the TPU kernel runs on the
    transposed grid; the port has no orientation swap."""
    got, xla, pallas = _both(*_setup(), base, 0.2, 0.05, 15, 5)
    np.testing.assert_allclose(got, xla, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)


def test_dedup_compares_previous_point_even_if_invalid():
    """A point in the same cell as the previous one is dropped whether or
    not that previous point is valid; point 0 is never a duplicate."""
    pts = torch.tensor([[0.01, 0.01], [0.02, 0.02], [0.03, 0.01],
                        [1.0, 1.0]])
    valid = torch.tensor([[False, True, True, True]])
    ix, iy, keep, count = K.volume_cells(
        torch.zeros(1, 2), 0.1, 40, pts, valid, torch.zeros(1, 3),
        torch.zeros(1))
    assert keep[0, 0].tolist() == [False, False, False, True]
    assert count.tolist() == [[1.0]]
    valid = torch.ones(1, 4, dtype=torch.bool)
    _, _, keep, count = K.volume_cells(torch.zeros(1, 2), 0.1, 40, pts,
                                       valid, torch.zeros(1, 3),
                                       torch.zeros(1))
    assert keep[0, 0].tolist() == [True, False, False, True]
    assert count.tolist() == [[2.0]]


def _batched_inputs(seed=5):
    rng = np.random.default_rng(seed)
    grids = np.stack([_setup(seed=s)[0] for s in (0, 1)])
    mov = rng.uniform(-3, 3, (120, 2)).astype(np.float32)
    gidx = np.array([1, 0, 1], np.int32)
    centers = np.array([[0.0, 0.0], [0.1, -0.2], [-0.3, 0.2]], np.float32)
    valid = rng.uniform(size=(3, 120)) > 0.15
    bases = np.array([[0.0, 0.0, 0.0], [0.4, -0.3, 0.7], [-0.2, 0.1, -2.0]],
                     np.float32)
    thetas = np.asarray(jmake_lattice(0.2, 0.05), np.float32)
    return grids, gidx, centers, mov, valid, bases, thetas


def test_batched_entry_point():
    """One batched call over (grid index, center, base) triples equals the
    reference's per-search volumes."""
    grids, gidx, centers, mov, valid, bases, thetas = _batched_inputs()
    ty = np.arange(-6, 7, dtype=np.int32)
    tx = np.arange(-4, 5, dtype=np.int32)
    got = TS.score_volume_auto(tf(grids), tf(gidx), tf(centers), 0.05,
                               tf(mov), torch.as_tensor(valid), tf(bases),
                               tf(thetas), tf(ty), tf(tx))
    assert got.shape == (3, len(thetas), 13, 9)
    for b in range(3):
        want = jscore_volume(jf(grids[gidx[b]]), jf(centers[b]), 0.05,
                             jf(mov), jnp.asarray(valid[b]), jf(bases[b]),
                             jf(thetas), jf(ty), jf(tx))
        np.testing.assert_allclose(npy(got[b]), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the batched entry point never touches the kernel."""
    grids, gidx, centers, mov, valid, bases, thetas = _batched_inputs()
    before = K.SCORE_VOLUME.launches
    ty = np.arange(-2, 3, dtype=np.int32)
    TS.score_volume_auto(tf(grids), tf(gidx), tf(centers), 0.05, tf(mov),
                         torch.as_tensor(valid), tf(bases), tf(thetas),
                         tf(ty), tf(ty))
    assert K.SCORE_VOLUME.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.SCORE_VOLUME(tf(grids), tf(gidx), *K.volume_cells(
            tf(centers), 0.05, grids.shape[-1], tf(mov),
            torch.as_tensor(valid), tf(bases), tf(thetas)), 2, 2)
