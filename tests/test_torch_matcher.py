"""Parity of the port's matcher (``matcher/grid.py``, ``search.py``,
``matching.py``) with ``cg_mrslam_tpu`` on the same float32 inputs.

Grids must agree to 1e-6 m (the reference's own bar against brute force,
``tests/test_matcher.py``). Search results must pick the same lattice
cell — poses to 1e-5 (float32 sums of base + offset), scores at the
score-volume tolerance (rtol 1e-5, atol 1e-6) — including the order of
exact ties in a corridor, where ``lax.top_k`` puts the lower flat index
first.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_mrslam_tpu.config import MatcherConfig, SearchWindows
from cg_mrslam_tpu.matcher import grid as JGR
from cg_mrslam_tpu.matcher import matching as JM
from cg_mrslam_tpu.matcher import search as JSE
from cg_mrslam_tpu.sim import world as JW
from cg_mrslam_tpu_torch.matcher import grid as TGR
from cg_mrslam_tpu_torch.matcher import matching as TM
from cg_mrslam_tpu_torch.matcher import search as TSE
from torch_port_helpers import jf, npy, tf

torch.set_num_threads(1)

CFG = MatcherConfig(extent=12.0, resolution=0.05, kernel_radius=0.2)
WIN = SearchWindows()


@pytest.mark.parametrize("kernel_radius,resolution", [(0.2, 0.05),
                                                      (0.5, 0.1)])
def test_build_grid(kernel_radius, resolution):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-4, 4, (300, 2)).astype(np.float32)
    valid = rng.uniform(size=300) > 0.2
    center = np.array([0.3, -0.2], np.float32)
    cells = int(round(8.0 / resolution))
    kw = dict(cells=cells, resolution=resolution,
              kernel_radius=kernel_radius)
    want = JGR.build_grid(jf(pts), jnp.asarray(valid), jf(center), **kw)
    got = TGR.build_grid(tf(pts), torch.as_tensor(valid), tf(center), **kw)
    np.testing.assert_allclose(npy(got), npy(want), atol=1e-6)
    # a batch of grids is the same as one grid per (points, center)
    pts2 = np.stack([pts, pts[::-1] * 0.5])
    val2 = np.stack([valid, valid])
    cen2 = np.stack([center, -center])
    many = TGR.build_grids(tf(pts2), torch.as_tensor(val2), tf(cen2), **kw)
    for b in range(2):
        one = JGR.build_grid(jf(pts2[b]), jnp.asarray(val2[b]),
                             jf(cen2[b]), **kw)
        np.testing.assert_allclose(npy(many[b]), npy(one), atol=1e-6)


def _search_both(grid, center, res, mov, valid, base, **kw):
    want = JSE.grid_search(jf(grid), jf(center), res, jf(mov),
                           jnp.asarray(valid), jf(base), **kw)
    got = TSE.grid_search(tf(grid), tf(center), res, tf(mov),
                          torch.as_tensor(valid), tf(base), **kw)
    return got, want


def test_corridor_ties_keep_reference_order():
    """Sliding along a corridor leaves exact ties (symmetric offsets pay
    the same tie-break penalty): the top-k order must be the reference's."""
    xs = np.arange(-4.0, 4.0, 0.02)
    ref = np.concatenate([np.stack([xs, np.full_like(xs, 1.0)], 1),
                          np.stack([xs, np.full_like(xs, -1.0)], 1)])
    ref = ref.astype(np.float32)
    grid = np.asarray(JGR.build_grid(
        jf(ref), jnp.ones(len(ref), bool), jnp.zeros(2, jnp.float32),
        cells=CFG.cells, resolution=CFG.resolution,
        kernel_radius=CFG.kernel_radius), np.float32)
    mx = np.arange(-2.0, 2.0, 0.1)
    mov = np.concatenate([np.stack([mx, np.full_like(mx, 1.0)], 1),
                          np.stack([mx, np.full_like(mx, -1.0)], 1)])
    mov = mov.astype(np.float32)
    got, want = _search_both(
        grid, np.zeros(2, np.float32), CFG.resolution, mov,
        np.ones(len(mov), bool), np.zeros(3, np.float32), th_span=0.1,
        th_res=0.025, x_span=0.3, y_span=0.3, topk=12)
    w_s = npy(want.scores)
    assert len(set(np.round(w_s, 7))) < len(w_s), "no exact ties to pin"
    np.testing.assert_allclose(npy(got.poses), npy(want.poses), atol=1e-5)
    np.testing.assert_allclose(npy(got.scores), w_s, rtol=1e-5, atol=1e-6)


def _world_scans(beams=180):
    world = JW.hospital_world(16.0, 10.0, seed=2)
    segs = world.as_jax()
    fov = 1.5 * np.pi
    poses = np.array([[4.0, 4.6, 0.1], [4.3, 4.7, 0.15]], np.float32)
    rng = [np.asarray(JW.raycast(segs, jf(p), beams, -fov / 2, fov / beams,
                                 8.0)) for p in poses]
    ang = -fov / 2 + fov / beams * np.arange(beams)
    pts = [np.stack([r * np.cos(ang), r * np.sin(ang)], 1).astype(np.float32)
           for r in rng]
    valid = [r < 8.0 * 0.9999 for r in rng]
    return poses, pts, valid


@pytest.mark.parametrize("noise", [(0.0, 0.0, 0.0), (0.07, -0.05, 0.04)])
def test_close_match(noise):
    poses, pts, valid = _world_scans()
    c, s = np.cos(poses[0, 2]), np.sin(poses[0, 2])
    ref_w = (pts[0] @ np.array([[c, s], [-s, c]], np.float32)
             + poses[0, :2]).astype(np.float32)
    guess = (poses[1] + np.asarray(noise, np.float32)).astype(np.float32)
    cfg = MatcherConfig(extent=16.0, resolution=0.05, kernel_radius=0.2)
    want = JM.close_match(jf(ref_w), jnp.asarray(valid[0]), jf(pts[1]),
                          jnp.asarray(valid[1]), jf(guess), cfg=cfg,
                          windows=WIN)
    got = TM.close_match(tf(ref_w), torch.as_tensor(valid[0]), tf(pts[1]),
                         torch.as_tensor(valid[1]), tf(guess), cfg=cfg,
                         windows=WIN)
    np.testing.assert_allclose(npy(got.pose), npy(want.pose), atol=1e-5)
    np.testing.assert_allclose(float(got.score), float(want.score),
                               rtol=1e-5, atol=1e-6)
    assert bool(got.accepted) == bool(want.accepted)
    assert bool(got.accepted)


def test_batched_search_equals_single_searches():
    poses, pts, valid = _world_scans()
    grids = np.stack([np.asarray(JGR.build_grid(
        jf(pts[k]), jnp.asarray(valid[k]), jnp.zeros(2, jnp.float32),
        cells=240, resolution=0.05, kernel_radius=0.2)) for k in (0, 1)])
    bases = np.array([[0.02, -0.03, 0.01], [0.0, 0.05, -0.02]], np.float32)
    vb = np.stack([valid[1], valid[0]])
    kw = dict(th_span=0.1, th_res=0.025, x_span=0.2, y_span=0.15, topk=3)
    got = TSE.grid_search_batched(
        tf(grids), tf(np.array([0, 1], np.int32)), torch.zeros(2, 2), 0.05,
        tf(pts[1]), torch.as_tensor(vb), tf(bases), **kw)
    for b in range(2):
        want = JSE.grid_search(jf(grids[b]), jnp.zeros(2, jnp.float32), 0.05,
                               jf(pts[1]), jnp.asarray(vb[b]), jf(bases[b]),
                               **kw)
        np.testing.assert_allclose(npy(got.poses[b]), npy(want.poses),
                                   atol=1e-5)
        np.testing.assert_allclose(npy(got.scores[b]), npy(want.scores),
                                   rtol=1e-5, atol=1e-6)
