"""Parity of the port's remaining matcher pieces with ``cg_mrslam_tpu``:
``grid.subsample``, ``search.unmatched_points`` / ``box_mean`` and the
matching modes ``loop_closure_match``, ``loop_closure_match_hierarchical``,
``global_match`` and ``verify_match``, on the CPU (plain versions of
kernels K1 and K2), on ``tests/test_matcher.py``'s scenes.

Tolerances and why:

* ``subsample`` and ``unmatched_points`` are integer cell arithmetic on the
  same float32 inputs: masks equal.
* ``box_mean`` sums the same cells in another order: rtol 1e-6.
* The searches pick lattice points: poses within 1e-4 (float32 sums of
  base + offset; the reference adds its offsets to a zero-angle base).
  Scores within 1e-5 — or, where a point changed cells, within one point's
  share of the mean, 2·kernel_radius / kept points. The reason: on these
  scenes the walls lie on the grid's lattice, so at the true pose many
  rotated points sit on a cell edge, and XLA's compiled rotation (its own
  float32 ``sin``, multiply-adds contracted into FMAs) rounds differently
  in the last bit from the port's (float64 ``cos``/``sin`` rounded once,
  separate products): a point on the edge then lands in the neighbouring
  cell and changes its term by up to ``kernel_radius`` and the dedup count
  by one. Both packages recover the planted transform to
  ``tests/test_matcher.py``'s own bars.
* ``verify_match``: the same decision, with the body and without.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_mrslam_tpu.config import MatcherConfig, SearchWindows
from cg_mrslam_tpu.matcher import grid as JGR
from cg_mrslam_tpu.matcher import matching as JM
from cg_mrslam_tpu.matcher import search as JSE
from cg_mrslam_tpu.utils import se2 as JSE2
from cg_mrslam_tpu_torch.matcher import grid as TGR
from cg_mrslam_tpu_torch.matcher import matching as TM
from cg_mrslam_tpu_torch.matcher import search as TSE
from test_matcher import CFG, LC_CFG, _scene
from torch_port_helpers import jf, npy, tf

torch.set_num_threads(1)

WIN = SearchWindows()


def _wrap(d):
    d = np.asarray(d, np.float64).copy()
    d[..., 2] = (d[..., 2] + np.pi) % (2 * np.pi) - np.pi
    return d


def _both(fn_name, args, **kw):
    """Run ``matching.<fn_name>`` in both packages on numpy inputs."""
    want = getattr(JM, fn_name)(*[jf(a) if np.asarray(a).dtype != bool
                                  else jnp.asarray(a) for a in args], **kw)
    got = getattr(TM, fn_name)(*[tf(a) if np.asarray(a).dtype != bool
                                 else torch.as_tensor(a) for a in args],
                               **kw)
    return got, want


def _clustered(seed=1, n=30, rep=4):
    rng = np.random.default_rng(seed)
    pts = np.repeat(rng.uniform(-3, 3, (n, 2)), rep, axis=0).astype(
        np.float32) + rng.normal(0, 0.005, (n * rep, 2)).astype(np.float32)
    valid = np.ones(n * rep, bool)
    valid[-7:] = False
    return pts, valid


@pytest.mark.parametrize("seed,center,extent,res", [
    (1, (0.0, 0.0), 10.0, 0.1),       # tests/test_matcher.py's inputs
    (2, (0.35, -0.2), 4.0, 0.1),      # some points off the grid
    (3, (0.0, 0.0), 10.0, 0.05)])
def test_subsample(seed, center, extent, res):
    pts, valid = _clustered(seed)
    cells = int(round(extent / res))
    want = JGR.subsample(jf(pts), jnp.asarray(valid), jf(np.asarray(center)),
                         cells=cells, resolution=res)
    got = TGR.subsample(tf(pts), torch.as_tensor(valid),
                        tf(np.asarray(center)), cells=cells, resolution=res)
    np.testing.assert_array_equal(npy(got), np.asarray(want))
    assert 0 < int(npy(got).sum()) < valid.sum()


def _grid_and_points(seed=4):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-3, 3, (200, 2)).astype(np.float32)
    center = np.asarray([0.15, -0.1], np.float32)
    grid = np.asarray(JGR.build_grid(
        jf(ref), jnp.ones(200, bool), jf(center), cells=80, resolution=0.1,
        kernel_radius=0.5), np.float32)
    pts = rng.uniform(-5, 5, (300, 2)).astype(np.float32)  # some off grid
    valid = rng.uniform(size=300) > 0.1
    return grid, center, pts, valid


@pytest.mark.parametrize("thr", [0.1, 0.3, 0.495])
def test_unmatched_points(thr):
    grid, center, pts, valid = _grid_and_points()
    want = JSE.unmatched_points(jf(grid), jf(center), 0.1, jf(pts),
                                jnp.asarray(valid), dist_threshold=thr)
    got = TSE.unmatched_points(tf(grid), tf(center), 0.1, tf(pts),
                               torch.as_tensor(valid), dist_threshold=thr)
    w = np.asarray(want)
    np.testing.assert_array_equal(npy(got), w)
    assert 0 < w.sum() < valid.sum()


@pytest.mark.parametrize("box", [(0.0, 0.0), (0.15, -0.1), (1.05, 0.35),
                                 (-2.03, 2.71), (3.9, -3.9), (9.0, 9.0)])
def test_box_mean(box):
    """Box centres on cell centres and on cell edges (where ``|w - c| <=
    0.3`` decides membership at the box's edge), near the grid's border and
    off the grid (no cell: the mean of nothing is 0)."""
    grid, center, _, _ = _grid_and_points()
    b = np.asarray(box, np.float32)
    want = JSE.box_mean(jf(grid), jf(center), 0.1, jf(b), box_half=0.3)
    got = TSE.box_mean(tf(grid), tf(center), 0.1, tf(b), box_half=0.3)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _pair(pose_a, pose_b):
    scan = _scene()
    pts_a, va = scan(pose_a)
    pts_b, vb = scan(pose_b)
    ref_world = np.asarray(JSE2.apply(jnp.asarray(pose_a), pts_a),
                           np.float32)
    return (ref_world, np.asarray(va), np.asarray(pts_b, np.float32),
            np.asarray(vb))


def _point_share(pts, valid, pose, cfg):
    """One point's share of the mean at ``pose``: 2·kernel_radius / the
    points kept there (after the duplicate-cell dedup)."""
    from cg_mrslam_tpu_torch.ops.correlate import volume_cells

    p = tf(pose)
    *_, count = volume_cells(p[None, :2], cfg.resolution, cfg.cells,
                             tf(pts), torch.as_tensor(valid)[None],
                             p[None], torch.zeros(1))
    return 2 * cfg.kernel_radius / float(count)


def _same_scores(got, want, share):
    """Scores within 1e-5, or within one point's share where a point on a
    cell edge rounded into the neighbouring cell (module docstring)."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=max(1e-5, share))


def _same_match(got, want, pts, valid, cfg):
    np.testing.assert_allclose(_wrap(npy(got.pose) - npy(want.pose)), 0.0,
                               atol=1e-4)
    _same_scores(float(got.score), float(want.score),
                 _point_share(pts, valid, npy(want.pose), cfg))
    assert bool(got.accepted) == bool(want.accepted)


def test_loop_closure_match():
    """``test_matcher.py::test_loop_closure_match_regions``: one valid region
    and one masked, each with its π twin, on one shared grid."""
    true_b = np.array([12.3, 10.4, 0.5], np.float32)
    ref, va, pts, vb = _pair(np.array([12.0, 10.0, 0.1], np.float32), true_b)
    regions = np.asarray([[12.0, 10.0, 0.4], [30.0, 10.0, 0.0]], np.float32)
    rvalid = np.asarray([True, False])
    got, want = _both("loop_closure_match", (ref, va, pts, vb, regions,
                                             rvalid), cfg=LC_CFG,
                      windows=WIN)
    assert got.poses.shape == (4, 3) and got.scores.shape == (4,)
    np.testing.assert_allclose(_wrap(npy(got.poses) - npy(want.poses)), 0.0,
                               atol=1e-4)
    for k, pose in enumerate(npy(want.poses)):
        _same_scores(float(got.scores[k]), float(want.scores[k]),
                     _point_share(pts, vb, pose, LC_CFG))
    for res in (got, want):
        s = npy(res.scores)
        assert s[1] == LC_CFG.kernel_radius and s[3] == LC_CFG.kernel_radius
        best = int(np.argmin(s))
        err = _wrap(npy(res.poses)[best] - true_b)
        assert s[best] < 0.2
        assert np.all(np.abs(err) <= [0.25, 0.25, 0.1]), err


def test_loop_closure_match_hierarchical():
    """``test_matcher.py::test_lc_hierarchical_mode``: a guess 0.8 m, 0.6 m,
    0.3 rad off, inside the ±2 m / ±1 rad window."""
    true_pose = np.array([8.0, 10.0, 0.4], np.float32)
    ref, vr, pts, vc = _pair(np.array([7.0, 9.5, 0.1], np.float32),
                             true_pose)
    guess = (true_pose + np.array([0.8, -0.6, 0.3], np.float32))
    got, want = _both("loop_closure_match_hierarchical",
                      (ref, vr, pts, vc, guess), cfg=CFG, windows=WIN)
    _same_match(got, want, pts, vc, CFG)
    for m in (got, want):
        err = _wrap(npy(m.pose) - true_pose)
        assert bool(m.accepted)
        assert np.all(np.abs(err) <= [0.3, 0.3, 0.1]), err


def test_global_match():
    """``test_matcher.py::test_global_match_recovers_large_rotation``: an
    unknown rotation of 2.4 rad, full −π..π search."""
    pose_a = np.array([20.0, 10.0, 0.0], np.float32)
    true_b = np.array([21.0, 9.4, 2.4], np.float32)
    ref, va, pts, vb = _pair(pose_a, true_b)
    got, want = _both("global_match", (ref, va, pts, vb, pose_a),
                      cfg=LC_CFG, windows=WIN)
    _same_match(got, want, pts, vb, LC_CFG)
    for m in (got, want):
        err = _wrap(npy(m.pose) - true_b)
        assert float(m.score) < 0.25
        assert np.all(np.abs(err) <= [0.2, 0.2, 0.06]), err


@pytest.mark.parametrize("with_body", [True, False])
def test_verify_match(with_body):
    """``test_matcher.py::test_verify_match_gate``: detected when my scan
    holds a cluster the peer's map cannot explain at its position (its
    body), rejected without it — the same decision in both packages."""
    pose_a = np.array([8.0, 10.0, 0.3], np.float32)
    pose_b = np.array([9.0, 10.0, 1.0], np.float32)
    my_pts, va, pts_b, vb = _pair(pose_a, pose_b)
    map_pts = np.asarray(JSE2.apply(jnp.asarray(pose_b), pts_b), np.float32)
    if with_body:
        body = pose_b[:2] + np.array(
            [[0.05, 0.0], [-0.05, 0.05], [0.0, -0.06], [0.08, 0.06],
             [-0.04, -0.04]], np.float32)
        my_pts = np.concatenate([my_pts, body]).astype(np.float32)
        va = np.concatenate([va, np.ones(len(body), bool)])
    lc = MatcherConfig(extent=20.0, resolution=0.1, kernel_radius=0.5)
    got, want = _both("verify_match", (map_pts, vb, my_pts, va, pose_b[:2]),
                      cfg=lc, threshold=40.0)
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == bool(want) == with_body
