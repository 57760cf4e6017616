"""Parity of the port's hierarchical search (``matcher/search.py``) and of
kernel K2's plain version with ``cg_mrslam_tpu``, on the CPU.

Tolerances and why:

* Strided volumes: the port's plain version (``ops/correlate.py:
  volume_plain``) and the reference's ``score_volume`` / its strided Pallas
  kernel in interpret mode see the same integer cells and differ only in
  the order of the float32 sums: rtol 1e-5, atol 1e-6 (the reference's
  own kernel-vs-XLA bar, ``tests/test_pallas_correlate.py``).
* Min-pool: a max over the same cells with the same padding: exact.
* Hierarchical search: the winning pose is a lattice point, so it must be
  the same point (1e-5 m / rad covers float32 rounding of ``base + k·step``)
  and its score agree to 1e-5; the other survivors are compared as sorted
  score lists to 1e-5, since a float32 near-tie may order two of them
  differently without changing the set.
"""

import jax.lax as lax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_mrslam_tpu.matcher.grid import build_grid
from cg_mrslam_tpu.matcher import search as JS
from cg_mrslam_tpu.ops.correlate import pallas_score_volume_strided
from cg_mrslam_tpu_torch.matcher import search as TS
from cg_mrslam_tpu_torch.ops import correlate as K
from torch_port_helpers import jf, npy, tf

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _setup(seed=0, n_ref=200, n_mov=150, cells=160, res=0.05):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-3, 3, size=(n_ref, 2)).astype(np.float32)
    grid = np.asarray(build_grid(jnp.asarray(ref), jnp.ones(n_ref, bool),
                                 jnp.zeros(2, jnp.float32), cells=cells,
                                 resolution=res, kernel_radius=0.2))
    mov = rng.uniform(-3, 3, size=(n_mov, 2)).astype(np.float32)
    valid = np.ones(n_mov, bool)
    valid[-20:] = False
    return grid, np.zeros(2, np.float32), res, mov, valid


@pytest.mark.parametrize("ny,nx,stride", [(3, 2, 8), (6, 12, 8), (2, 2, 4),
                                          (2, 2, 2)])
def test_strided_plain_matches_reference(ny, nx, stride):
    grid, center, res, mov, valid = _setup(seed=4)
    thetas = np.asarray(JS.make_lattice(0.4, 0.1))
    ty = np.arange(-ny, ny + 1, dtype=np.int32) * stride
    tx = np.arange(-nx, nx + 1, dtype=np.int32) * stride
    b = np.asarray([0.3, -0.2, 0.5], np.float32)
    want = JS.score_volume(jf(grid), jf(center), res, jf(mov),
                           jnp.asarray(valid), jf(b), jf(thetas),
                           jnp.asarray(ty), jnp.asarray(tx))
    got = TS.score_volume_auto(
        tf(grid)[None], torch.zeros(1, dtype=torch.int32), tf(center)[None],
        res, tf(mov), torch.as_tensor(valid)[None], tf(b)[None],
        tf(thetas), ty, tx, kind="strided")[0]
    assert got.shape == (len(thetas), 2 * ny + 1, 2 * nx + 1)
    np.testing.assert_allclose(npy(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    if (ny, nx, stride) == (3, 2, 8):
        kern = pallas_score_volume_strided(
            jf(grid), jf(center), res, jf(mov), jnp.asarray(valid), jf(b),
            jf(thetas), ty, tx, interpret=True)
        np.testing.assert_allclose(npy(got), np.asarray(kern), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("ny,nx,stride,n_base", [(6, 12, 8, 1), (2, 2, 4, 5),
                                                 (2, 2, 2, 5), (2, 2, 1, 5)])
def test_pair_plain_matches_reference(ny, nx, stride, n_base):
    """K2's fused ``known_cap`` pair, plain (``volume_pair_plain`` through
    ``score_volume_auto``), against the reference's known-cap scoring at
    the level-0 and refine lattices: ``score_volume`` over ``g·known`` and
    over ``known`` for every base, as its ``level_search`` does. Sum order
    only: rtol 1e-5, atol 1e-6."""
    grid, center, res, mov, valid = _setup(seed=5)
    cap = 0.2 * 0.999          # the grid saturates at its 0.2 m radius
    rng = np.random.default_rng(stride)
    bases = np.concatenate([rng.uniform(-0.5, 0.5, (n_base, 2)),
                            rng.uniform(-0.5, 0.5, (n_base, 1))],
                           1).astype(np.float32)
    thetas = np.asarray(JS.make_lattice(0.1, 0.05))
    ty = np.arange(-ny, ny + 1, dtype=np.int32) * stride
    tx = np.arange(-nx, nx + 1, dtype=np.int32) * stride
    known = (jf(grid) < cap).astype(jnp.float32)
    assert 0 < float(known.mean()) < 1
    got = TS.score_volume_auto(
        tf(grid)[None], torch.zeros(n_base, dtype=torch.int32),
        tf(center)[None].expand(n_base, 2), res, tf(mov),
        torch.as_tensor(valid)[None].expand(n_base, -1), tf(bases),
        tf(thetas), ty, tx, kind="strided", known_cap=cap)
    assert got.shape == (n_base, 2, len(thetas), 2 * ny + 1, 2 * nx + 1)
    for b in range(n_base):
        for ch, g in enumerate((jf(grid) * known, known)):
            want = JS.score_volume(g, jf(center), res, jf(mov),
                                   jnp.asarray(valid), jf(bases[b]),
                                   jf(thetas), jnp.asarray(ty),
                                   jnp.asarray(tx))
            np.testing.assert_allclose(npy(got[b, ch]), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)


def test_strided_lattice_checks():
    assert TS._stride(np.arange(-6, 7) * 8) == (6, 8)
    assert TS._stride(np.arange(-2, 3)) == (2, 1)
    for bad in (np.arange(-2, 2), np.array([-3, 0, 4]), np.arange(-2, 3) * -1):
        with pytest.raises(ValueError, match="strided lattice"):
            TS._stride(bad)
    grid, center, res, mov, valid = _setup()
    before = K.SCORE_VOLUME_STRIDED.launches
    TS.score_volume_auto(tf(grid)[None], torch.zeros(1, dtype=torch.int32),
                         tf(center)[None], res, tf(mov),
                         torch.as_tensor(valid)[None],
                         torch.zeros(1, 3), torch.zeros(1),
                         np.arange(-2, 3) * 4, np.arange(-2, 3) * 4,
                         kind="strided")
    assert K.SCORE_VOLUME_STRIDED.launches == before
    cells = K.volume_cells(tf(center)[None], res, grid.shape[-1], tf(mov),
                           torch.as_tensor(valid)[None], torch.zeros(1, 3),
                           torch.zeros(1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.SCORE_VOLUME_STRIDED(tf(grid)[None],
                               torch.zeros(1, dtype=torch.int32), *cells,
                               2, 2, 4, 4)


def test_pair_and_probes_take_cuda_tensors_only():
    """The pair and the probes launch a kernel or raise: on CPU tensors
    they raise, and a known-cap search on the CPU takes the plain pair
    without counting a launch; ``known_cap`` needs the strided kind."""
    grid, center, res, mov, valid = _setup()
    cells = K.volume_cells(tf(center)[None], res, grid.shape[-1], tf(mov),
                           torch.as_tensor(valid)[None], torch.zeros(1, 3),
                           torch.zeros(1))
    args = (tf(grid)[None], torch.zeros(1, dtype=torch.int32)) + cells
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.SCORE_VOLUME_STRIDED(*args, 2, 2, 4, 4, 0.1)
    for probe in (K.PROBE_NO_GATHER, K.PROBE_CONST_CELLS):
        with pytest.raises(ValueError, match="CUDA tensors"):
            probe(*args, 2, 2, 1, 1)
    with pytest.raises(ValueError, match="unknown probe"):
        K.probe_plain("x3", *args, torch.zeros(1), torch.zeros(1))
    before = K.SCORE_VOLUME_STRIDED.launches
    vol = TS.score_volume_auto(
        tf(grid)[None], torch.zeros(1, dtype=torch.int32), tf(center)[None],
        res, tf(mov), torch.as_tensor(valid)[None], torch.zeros(1, 3),
        torch.zeros(1), np.arange(-2, 3) * 4, np.arange(-2, 3) * 4,
        kind="strided", known_cap=0.1)
    assert vol.shape == (1, 2, 1, 5, 5)
    assert K.SCORE_VOLUME_STRIDED.launches == before
    with pytest.raises(ValueError, match="strided kind"):
        TS.score_volume_auto(
            tf(grid)[None], torch.zeros(1, dtype=torch.int32),
            tf(center)[None], res, tf(mov), torch.as_tensor(valid)[None],
            torch.zeros(1, 3), torch.zeros(1), torch.arange(-2, 3),
            torch.arange(-2, 3), known_cap=0.1)


@pytest.mark.parametrize("w", [2, 4, 8])
def test_min_pool_padding(w):
    """XLA's SAME padding for an even window puts (w-1)//2 cells before
    and the rest after; a symmetric pool would shift the grid by one."""
    g = np.random.default_rng(w).uniform(0, 1, (37, 37)).astype(np.float32)
    want = -lax.reduce_window(-jf(g), -jnp.inf, lax.max, (w, 1), (1, 1),
                              "SAME")
    want = -lax.reduce_window(-want, -jnp.inf, lax.max, (1, w), (1, 1),
                              "SAME")
    got = TS.min_pool(tf(g), w)
    np.testing.assert_array_equal(npy(got), np.asarray(want))


def _basin_setup(seed=3):
    """A sparse dotted wall plus a cross wall (``tests/test_search_pooled
    .py``): a narrow basin that point sampling at step 8 misses."""
    rng = np.random.default_rng(seed)
    xs = np.arange(-6.0, 6.0, 0.25)
    pts = np.stack([xs, np.full_like(xs, 2.0)], -1)
    pts = np.concatenate([pts, np.stack(
        [np.full(30, -3.0), np.linspace(-4, 4, 30)], -1)])
    pts = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    res = 0.1
    grid = np.asarray(build_grid(jnp.asarray(pts),
                                 jnp.ones(len(pts), bool),
                                 jnp.zeros(2, jnp.float32), cells=160,
                                 resolution=res, kernel_radius=0.2))
    return grid, np.zeros(2, np.float32), res, pts


@pytest.mark.parametrize("known,pool", [(False, False), (False, True),
                                        (True, True), (True, False)])
def test_hierarchical_search_matches_reference(known, pool):
    grid, center, res, pts = _basin_setup()
    moving = pts - np.asarray([0.35, -0.35], np.float32)
    # a few points far off the map: the coverage gate has work to do
    moving[::9] += 30.0
    valid = np.ones(len(moving), bool)
    valid[::13] = False
    base = np.asarray([0.05, -0.02, 0.03], np.float32)
    kw = dict(th_span=0.2, th_res=0.025, x_span=2.0, y_span=1.5, levels=4,
              branch=8, known_cap=(0.2 * 0.999 if known else None),
              min_known=0.55 if known else 0.0, pool_coarse=pool)
    want = JS.hierarchical_search(jf(grid), jf(center), res, jf(moving),
                                  jnp.asarray(valid), jf(base), **kw)
    got = TS.hierarchical_search(tf(grid), tf(center), res, tf(moving),
                                 torch.as_tensor(valid), tf(base), **kw)
    assert got.poses.shape == (8, 3) and got.scores.shape == (8,)
    np.testing.assert_allclose(npy(got.poses)[0], np.asarray(want.poses)[0],
                               atol=1e-5)
    np.testing.assert_allclose(npy(got.scores)[0],
                               np.asarray(want.scores)[0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.sort(npy(got.scores)),
                               np.sort(np.asarray(want.scores)), rtol=1e-5,
                               atol=1e-6)
    if pool:
        best = npy(got.poses)[0]
        assert np.hypot(best[0] - 0.35, best[1] + 0.35) < 0.15, best


def test_known_cap_gate():
    """Half the scan off the map: coverage ≈ 0.5 passes a 0.3 floor with a
    small score and fails a 0.9 floor at the 1e3 sentinel, as in the
    reference (``tests/test_search_pooled.py``)."""
    grid, center, res, pts = _basin_setup()
    moving = np.concatenate([pts[:40], pts[:40] + 30.0])
    valid = torch.ones(len(moving), dtype=torch.bool)
    kw = dict(th_span=0.05, th_res=0.05, x_span=0.2, y_span=0.2, levels=1,
              branch=1, known_cap=0.2 * 0.999)
    ok = TS.hierarchical_search(tf(grid), tf(center), res, tf(moving), valid,
                                torch.zeros(3), min_known=0.3, **kw)
    assert float(ok.scores[0]) < 0.05
    gated = TS.hierarchical_search(tf(grid), tf(center), res, tf(moving),
                                   valid, torch.zeros(3), min_known=0.9,
                                   **kw)
    assert float(gated.scores[0]) > 100.0
