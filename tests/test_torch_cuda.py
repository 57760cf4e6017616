"""Card-only tests of the PyTorch/CUDA port: the score-volume kernel against
its plain version, its launch count and input checks, and a keyframe step
with no host synchronization. Every test carries the ``cuda`` marker and
skips where there is no NVIDIA GPU.

This file imports neither JAX nor ``cg_mrslam_tpu``, so it also runs on a
machine without them (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    PYTHONPATH=. python -m pytest --noconftest -o addopts= -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from cg_mrslam_tpu_torch.ops import correlate as K

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-6
# the main path's windows (T, ry, rx, grid cells, resolution, batch)
SHAPES = [(65, 12, 12, 1200, 0.025, 1), (17, 3, 3, 700, 0.1, 4),
          (65, 15, 5, 700, 0.1, 8)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU path")
    return torch.device("cuda")


def _inputs(dev, t, cells, res, bsz, seed=0):
    from cg_mrslam_tpu_torch.matcher.grid import build_grids

    rng = np.random.default_rng(seed)
    n_grids = max(1, bsz // 2) if bsz > 4 else bsz
    half = cells * res / 2
    ref = torch.as_tensor(rng.uniform(-half * 0.8, half * 0.8,
                                      (n_grids, 3000, 2)), dtype=torch.float32)
    grids = build_grids(ref.to(dev),
                        torch.ones(n_grids, 3000, dtype=torch.bool,
                                   device=dev),
                        torch.zeros(n_grids, 2, device=dev), cells=cells,
                        resolution=res, kernel_radius=0.3)
    pts = torch.as_tensor(rng.uniform(-half * 0.6, half * 0.6, (360, 2)),
                          dtype=torch.float32, device=dev)
    valid = torch.as_tensor(rng.uniform(size=(bsz, 360)) > 0.1, device=dev)
    bases = torch.as_tensor(rng.uniform(-1, 1, (bsz, 3)),
                            dtype=torch.float32, device=dev)
    gidx = (torch.arange(bsz, device=dev) % n_grids).to(torch.int32)
    thetas = torch.linspace(-0.4, 0.4, t, device=dev)
    cells_ = K.volume_cells(torch.zeros(bsz, 2, device=dev), res, cells,
                            pts, valid, bases, thetas)
    return grids, gidx, cells_


@pytest.mark.parametrize("t,ry,rx,cells,res,bsz", SHAPES)
def test_kernel_matches_plain(dev, t, ry, rx, cells, res, bsz):
    grids, gidx, (ix, iy, keep, count) = _inputs(dev, t, cells, res, bsz)
    before = K.SCORE_VOLUME.launches
    got = K.SCORE_VOLUME(grids, gidx, ix, iy, keep, count, ry, rx)
    assert K.SCORE_VOLUME.launches == before + 1
    ty = torch.arange(-ry, ry + 1, dtype=torch.int32, device=dev)
    tx = torch.arange(-rx, rx + 1, dtype=torch.int32, device=dev)
    want = K.volume_plain(grids, gidx, ix, iy, keep, count, ty, tx)
    torch.cuda.synchronize()
    assert got.shape == (bsz, t, 2 * ry + 1, 2 * rx + 1)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_kernel_rejects_bad_inputs(dev):
    grids, gidx, (ix, iy, keep, count) = _inputs(dev, 5, 200, 0.1, 2)
    with pytest.raises(ValueError, match="ix"):
        K.SCORE_VOLUME(grids, gidx, ix.long(), iy, keep, count, 2, 2)
    with pytest.raises(ValueError, match="gidx"):
        K.SCORE_VOLUME(grids, gidx[:1], ix, iy, keep, count, 2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        K.SCORE_VOLUME(grids, gidx, ix.transpose(1, 2).contiguous()
                       .transpose(1, 2), iy, keep, count, 2, 2)


def test_keyframe_step_makes_no_host_sync(dev):
    """A whole keyframe step on the card with synchronizing calls turned
    into errors (the bucketed step adds exactly one, its fetch)."""
    from cg_mrslam_tpu_torch.config import Config, MatcherConfig
    from cg_mrslam_tpu_torch.pipeline import slam as S
    from cg_mrslam_tpu_torch.sim import world as W

    cfg = Config(close_matcher=MatcherConfig(extent=16.0, resolution=0.05,
                                             kernel_radius=0.2),
                 lc_matcher=MatcherConfig(extent=24.0, resolution=0.1,
                                          kernel_radius=0.5),
                 max_vertices=64, max_edges=256)
    fov = 1.5 * math.pi
    traj = W.simulate_robot(W.hospital_world(16.0, 10.0, seed=2),
                            W.corridor_waypoints(16.0, 10.0, 0, 1), seed=5,
                            beams=120, max_range=8.0, device=dev)
    slam = S.SingleRobotSlam(cfg, 120, traj.gt[0], traj.ranges[0], fov=fov,
                             max_range=8.0, device=dev)
    t = 1
    while len(slam.infos) < 12:
        slam.observe(traj.rel_odom[t - 1], traj.ranges[t])
        t += 1
    est = torch.as_tensor(slam.infos[-1].pose, device=dev)
    ranges = torch.as_tensor(traj.ranges[t], device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, info = S.keyframe_step(slam.state, est, ranges, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(state.graph.n_vertices) == 14
    assert np.isfinite(float(info.chi2))
