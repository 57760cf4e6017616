"""Card-only tests of the PyTorch/CUDA port: the score-volume kernels K1
and K2 (and K2's fused ``known_cap`` pair) against their plain version — at
the main path's shapes and at edge cases, bit-identical on repeat, exact
ties kept —, the timing probes against theirs and kept off the main path,
their launch counts and input checks, the solver's masked loops and
condense on the card against the CPU, a keyframe step with no host
synchronization, the solver's float sums repeated bit for bit (summed with
``index_add_``, these repeats differed), and the occupancy map on the card
against the CPU. Every test carries the ``cuda`` marker and skips where
there is no NVIDIA GPU.

This file imports neither JAX nor ``cg_mrslam_tpu``, so it also runs on a
machine without them (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    PYTHONPATH=. python -m pytest --noconftest -o addopts= -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import math
from pathlib import Path

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


def _inputs(dev, t, cells, res, bsz, seed=0, n_pts=360, spread=0.6):
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
    pts = torch.as_tensor(rng.uniform(-half * spread, half * spread,
                                      (n_pts, 2)),
                          dtype=torch.float32, device=dev)
    valid = torch.as_tensor(rng.uniform(size=(bsz, n_pts)) > 0.1,
                            device=dev)
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


# K2 at the multi-robot path's lattices (T, ny, nx, stride, batch): level 0
# of the hierarchical search (the known-cap pair of grids) and the three
# refine levels (48 survivors x 2 grids)
STRIDED = [(13, 6, 12, 8, 2), (5, 2, 2, 4, 96), (5, 2, 2, 2, 96),
           (5, 2, 2, 1, 96)]


@pytest.mark.parametrize("t,ny,nx,stride,bsz", STRIDED)
def test_strided_kernel_matches_plain(dev, t, ny, nx, stride, bsz):
    grids, gidx, (ix, iy, keep, count) = _inputs(dev, t, 700, 0.1, bsz,
                                                 seed=stride)
    before = K.SCORE_VOLUME_STRIDED.launches
    got = K.SCORE_VOLUME_STRIDED(grids, gidx, ix, iy, keep, count, ny, nx,
                                 stride, stride)
    assert K.SCORE_VOLUME_STRIDED.launches == before + 1
    ty = torch.arange(-ny, ny + 1, dtype=torch.int32, device=dev) * stride
    tx = torch.arange(-nx, nx + 1, dtype=torch.int32, device=dev) * stride
    want = K.volume_plain(grids, gidx, ix, iy, keep, count, ty, tx)
    torch.cuda.synchronize()
    assert got.shape == (bsz, t, 2 * ny + 1, 2 * nx + 1)
    # the comparison can fail: scores vary along both offset axes
    assert float((want.amax(2) - want.amin(2)).max()) > 100 * ATOL
    assert float((want.amax(3) - want.amin(3)).max()) > 100 * ATOL
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    # the fused known-cap pair at the same lattice (the path's form)
    pair = K.SCORE_VOLUME_STRIDED(grids, gidx, ix, iy, keep, count, ny, nx,
                                  stride, stride, 0.25)
    torch.testing.assert_close(
        pair, K.volume_pair_plain(grids, gidx, ix, iy, keep, count, ty, tx,
                                  0.25), rtol=RTOL, atol=ATOL)


def test_strided_kernel_rejects_bad_inputs(dev):
    grids, gidx, (ix, iy, keep, count) = _inputs(dev, 5, 200, 0.1, 2)
    with pytest.raises(ValueError, match="bad lattice"):
        K.SCORE_VOLUME_STRIDED(grids, gidx, ix, iy, keep, count, 2, 2, 0, 1)
    with pytest.raises(ValueError, match="keep"):
        K.SCORE_VOLUME_STRIDED(grids, gidx, ix, iy, keep.to(torch.uint8),
                               count, 2, 2, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.SCORE_VOLUME_STRIDED(grids.cpu(), gidx, ix, iy, keep, count, 2, 2,
                               4, 4)


def test_hierarchical_search_launches_k2_per_level(dev, monkeypatch):
    """Every level of a known-cap search is one launch of K2's fused pair
    (B = 1 at level 0, branch after) on the one grid — no stacked grid —,
    no probe runs, and the card's result is the CPU's."""
    from cg_mrslam_tpu_torch.matcher import search as TS

    seen = []

    def spy(*args):
        seen.append((args[0].shape[0], args[10]))
        return K.SCORE_VOLUME_STRIDED(*args)

    monkeypatch.setattr(TS, "SCORE_VOLUME_STRIDED", spy)
    probes = [K.PROBE_NO_GATHER.launches, K.PROBE_CONST_CELLS.launches]

    grids, _, _ = _inputs(dev, 1, 300, 0.1, 1, seed=7)
    rng = np.random.default_rng(7)
    pts = torch.as_tensor(rng.uniform(-8, 8, (360, 2)), dtype=torch.float32)
    valid = torch.ones(360, dtype=torch.bool)
    base = torch.tensor([0.2, -0.1, 0.05])
    kw = dict(th_span=0.3, th_res=0.025, x_span=2.0, y_span=1.5, levels=4,
              branch=16, known_cap=0.3 * 0.999, min_known=0.3,
              pool_coarse=True)
    before = K.SCORE_VOLUME_STRIDED.launches
    by_shape = dict(K.SCORE_VOLUME_STRIDED.launches_by_shape)
    got = TS.hierarchical_search(grids[0], torch.zeros(2, device=dev), 0.1,
                                 pts.to(dev), valid.to(dev), base.to(dev),
                                 **kw)
    assert K.SCORE_VOLUME_STRIDED.launches == before + 4
    new = {k: v - by_shape.get(k, 0)
           for k, v in K.SCORE_VOLUME_STRIDED.launches_by_shape.items()
           if v != by_shape.get(k, 0)}
    # keys (B, 2, T, Dy, Dx, sy, sx): level 0 at stride 8, refines at 4,
    # 2, 1
    assert sorted(k[:2] + k[-2:] for k in new) == [
        (1, 2, 8, 8), (16, 2, 1, 1), (16, 2, 2, 2), (16, 2, 4, 4)], new
    assert all(k[2:5] == (5, 5, 5) for k in new if k[0] == 16), new
    assert seen == [(1, kw["known_cap"])] * 4, seen
    assert [K.PROBE_NO_GATHER.launches,
            K.PROBE_CONST_CELLS.launches] == probes
    want = TS.hierarchical_search(grids[0].cpu(), torch.zeros(2), 0.1, pts,
                                  valid, base, **kw)
    # survivors as a sorted score list: a float32 near-tie may order two
    # of them differently without changing the set
    torch.testing.assert_close(torch.sort(got.scores.cpu()).values,
                               torch.sort(want.scores).values, rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(got.poses[0].cpu(), want.poses[0], rtol=0,
                               atol=1e-5)


def _lattice(n, s, dev):
    return torch.arange(-n, n + 1, dtype=torch.int32, device=dev) * s


# edge cases (T, ny, nx, stride, cells, batch, points, spread of the points
# over the grid: > 1 puts many off it): one point, a ragged warp slice, the
# main path's count and one more, the most the kernel takes; few and many
# (b, t) blocks against the 132 SMs; points off the grid
EDGES = [(5, 2, 2, 1, 200, 2, 1, 0.6), (5, 2, 2, 1, 200, 2, 31, 0.6),
         (7, 3, 6, 2, 300, 3, 360, 0.6), (7, 3, 6, 2, 300, 3, 361, 0.6),
         (3, 2, 3, 1, 300, 2, K.MAX_POINTS, 0.6),
         (2, 12, 12, 1, 400, 1, 200, 0.6), (40, 2, 2, 4, 400, 40, 200, 0.6),
         (9, 4, 4, 1, 200, 4, 360, 2.5)]


@pytest.mark.parametrize("t,ny,nx,stride,cells,bsz,n_pts,spread", EDGES)
def test_kernel_edge_cases(dev, t, ny, nx, stride, cells, bsz, n_pts,
                           spread):
    grids, gidx, cells_ = _inputs(dev, t, cells, 0.1, bsz, seed=n_pts,
                                  n_pts=n_pts, spread=spread)
    ty, tx = _lattice(ny, stride, dev), _lattice(nx, stride, dev)
    want = K.volume_plain(grids, gidx, *cells_, ty, tx)
    got = K.SCORE_VOLUME_STRIDED(grids, gidx, *cells_, ny, nx, stride,
                                 stride)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    if spread > 1:  # some points fall off the grid, some stay on
        ix, iy = cells_[0], cells_[1]
        off = (ix < 0) | (iy < 0) | (ix >= cells) | (iy >= cells)
        assert bool(off.any()) and not bool(off.all())
    pair = K.SCORE_VOLUME_STRIDED(grids, gidx, *cells_, ny, nx, stride,
                                  stride, 0.2)
    torch.testing.assert_close(
        pair, K.volume_pair_plain(grids, gidx, *cells_, ty, tx, 0.2),
        rtol=RTOL, atol=ATOL)


def test_kernel_points_limit(dev):
    grids, gidx, (ix, iy, keep, count) = _inputs(
        dev, 2, 100, 0.1, 1, n_pts=K.MAX_POINTS + 1)
    with pytest.raises(ValueError, match="points"):
        K.SCORE_VOLUME(grids, gidx, ix, iy, keep, count, 1, 1)


def test_kernel_dropped_points_and_bad_grid(dev):
    """Every point dropped: volumes of exactly 0 (count clamps to 1); a
    grid index out of range poisons its volumes with NaN, the others are
    untouched."""
    grids, gidx, (ix, iy, keep, count) = _inputs(dev, 5, 200, 0.1, 3)
    none = torch.zeros_like(keep)
    got = K.SCORE_VOLUME(grids, gidx, ix, iy, none,
                         torch.ones_like(count), 2, 2)
    assert bool((got == 0).all())
    bad = gidx.clone()
    bad[1] = grids.shape[0]
    for cap in (None, 0.2):
        args = (grids, bad, ix, iy, keep, count, 2, 2, 1, 1)
        out = K.SCORE_VOLUME_STRIDED(*args, cap)
        assert bool(out[1].isnan().all())
        assert not bool(out[0].isnan().any() | out[2].isnan().any())


def test_kernel_repeats_bit_for_bit(dev):
    """No atomics: two launches on the same inputs give the same bits, at
    a shape with many warps per volume (close) and with the pair."""
    grids, gidx, cells_ = _inputs(dev, 65, 1200, 0.025, 1)
    a = K.SCORE_VOLUME(grids, gidx, *cells_, 12, 12)
    b = K.SCORE_VOLUME(grids, gidx, *cells_, 12, 12)
    assert torch.equal(a, b)
    grids, gidx, cells_ = _inputs(dev, 5, 700, 0.1, 48)
    a = K.SCORE_VOLUME_STRIDED(grids, gidx, *cells_, 2, 2, 4, 4, 0.2)
    b = K.SCORE_VOLUME_STRIDED(grids, gidx, *cells_, 2, 2, 4, 4, 0.2)
    assert torch.equal(a, b)


def test_kernel_keeps_exact_ties(dev):
    """On a grid constant along x, with every shifted cell on the grid,
    all offsets j of a row see the same values in the same order: they
    must be exactly equal (corridor ties that ``volume_topk`` orders)."""
    cells = 300
    rows = torch.linspace(0.0, 0.5, cells, device=dev)
    grids = rows[None, :, None].expand(1, cells, cells).contiguous()
    gidx = torch.zeros(2, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(rng.uniform(-8, 8, (360, 2)),
                          dtype=torch.float32, device=dev)
    valid = torch.ones(2, 360, dtype=torch.bool, device=dev)
    bases = torch.tensor([[0.1, 0.2, 0.3], [-0.3, 0.1, -1.0]], device=dev)
    cells_ = K.volume_cells(torch.zeros(2, 2, device=dev), 0.1, cells, pts,
                            valid, bases, torch.linspace(-0.3, 0.3, 9,
                                                         device=dev))
    for vol in (K.SCORE_VOLUME(grids, gidx, *cells_, 12, 12),
                K.SCORE_VOLUME_STRIDED(grids, gidx, *cells_, 3, 6, 2, 2),
                K.SCORE_VOLUME_STRIDED(grids, gidx, *cells_, 3, 6, 2, 2,
                                       0.3)):
        assert bool((vol == vol[..., :1]).all())
        assert float((vol.amax(-2) - vol.amin(-2)).max()) > 1e-3


@pytest.mark.parametrize("stride,bsz", [(8, 1), (4, 48), (1, 48)])
def test_pair_matches_two_grid_launch(dev, stride, bsz):
    """The fused pair equals K2 over the stacked ``[g·known, known]`` with
    every search repeated (the path it replaces), to float32 rounding."""
    grids, gidx, (ix, iy, keep, count) = _inputs(dev, 5, 700, 0.1, bsz,
                                                 seed=stride)
    grids, gidx = grids[:1], torch.zeros_like(gidx)
    cap = 0.3 * 0.999
    pair = K.SCORE_VOLUME_STRIDED(grids, gidx, ix, iy, keep, count, 2, 3,
                                  stride, stride, cap)
    two = K.SCORE_VOLUME_STRIDED(*K.stack_pair(grids, gidx, ix, iy, keep,
                                               count, cap), 2, 3, stride,
                                 stride)
    assert pair.shape == (bsz, 2, 5, 5, 7)
    torch.testing.assert_close(pair, two.reshape(pair.shape), rtol=RTOL,
                               atol=ATOL)
    # the coverage channel counts cells: exact
    torch.testing.assert_close(pair[:, 1], two.reshape(pair.shape)[:, 1],
                               rtol=0, atol=0)


@pytest.mark.parametrize("probe", [K.PROBE_NO_GATHER, K.PROBE_CONST_CELLS],
                         ids=lambda p: p.mode)
def test_probe_matches_its_plain_version(dev, probe):
    grids, gidx, cells_ = _inputs(dev, 17, 700, 0.1, 4)
    before = probe.launches
    got = probe(grids, gidx, *cells_, 3, 3, 1, 1)
    assert probe.launches == before + 1
    want = K.probe_plain(probe.mode, grids, gidx, *cells_, _lattice(3, 1, dev),
                         _lattice(3, 1, dev))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_masked_loop_on_the_card_matches_cpu(dev):
    """Per-entry exits of ``masked_loop`` land on the same iteration on
    the card as on the CPU."""
    from cg_mrslam_tpu_torch.solver.spd import masked_loop

    def body(s):
        x, n = s
        go = (x - 2.0).abs() > 1e-3
        return (torch.where(go, 0.9 * x + 0.2, x), n + go.to(n.dtype)), go

    # entries near the fixed point 2 stop early, the far ones run out the
    # budget (61: not a multiple of the host's look every 8 iterations)
    x0 = torch.linspace(1.995, 40.0, 37)
    n0 = torch.zeros(37, dtype=torch.int32)
    for budget in (64, 61):
        want = masked_loop(body, (x0, n0), budget)
        got = masked_loop(body, (x0.to(dev), n0.to(dev)), budget)
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(got[1].cpu(), want[1])
        assert int(want[1].min()) < 24 and int(want[1].max()) == budget


def _merged_graph(n_own, n_loops, cap_v=300, cap_e=600, seed=0):
    """One robot's chain (slots in keyframe order, a foreign edgeless
    vertex after every 9th) plus ``n_loops`` loop edges, all owned by
    robot 0; returns the graph, owner and keyframe index per slot."""
    from cg_mrslam_tpu_torch.core import graph as G

    rng = np.random.default_rng(seed)
    g = G.empty(cap_v, cap_e, "cpu")
    poses = np.cumsum(rng.normal(0, 0.5, (n_own, 3)) * [1.0, 0.4, 0.2], 0)
    vo, vr, own = np.zeros(cap_v, np.int32), np.zeros(cap_v, np.int32), []
    slot = 0
    for k in range(n_own):
        if k % 9 == 8:
            g = G.add_vertex(g, torch.as_tensor(rng.normal(0, 5, 3),
                                                dtype=torch.float32))
            vo[slot], vr[slot] = 1, k
            slot += 1
        g = G.add_vertex(g, torch.as_tensor(poses[k], dtype=torch.float32),
                         fixed=(k == 0))
        vr[slot] = k
        own.append(slot)
        slot += 1

    def rel(i, j):
        c, s = np.cos(poses[i, 2]), np.sin(poses[i, 2])
        d = poses[j] - poses[i]
        return [c * d[0] + s * d[1], -s * d[0] + c * d[1],
                (d[2] + np.pi) % (2 * np.pi) - np.pi]

    info = torch.tensor([100.0, 0.0, 0.0, 100.0, 0.0, 1000.0])
    pairs = [(k, k + 1) for k in range(n_own - 1)]
    pairs += [tuple(sorted(rng.choice(n_own, 2, replace=False)))
              for _ in range(n_loops)]
    for i, j in pairs:
        z = torch.as_tensor(np.asarray(rel(i, j)) + rng.normal(0, 0.01, 3),
                            dtype=torch.float32)
        g = G.add_edge(g, own[i], own[j], z, info, owner=0)
    return g, torch.as_tensor(vo), torch.as_tensor(vr), own


@pytest.mark.parametrize("n_loops,band", [(12, "chain"), (90, "pcg")])
def test_condense_on_the_card_matches_cpu(dev, n_loops, band):
    """Condense above DENSE_MAX (the path's capacity band: chain where the
    own-edge graph is chainable under the permutation, PCG past
    ``loop_cap``) on the card against the CPU.
    Bars as in ``tests/test_torch_mr.py``: z 1e-4, information 2e-2."""
    import dataclasses

    from cg_mrslam_tpu_torch.core import graph as G
    from cg_mrslam_tpu_torch.mr import condensed as CG
    from cg_mrslam_tpu_torch.solver import chain as CH
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn

    g, vo, vr, own = _merged_graph(240, n_loops)
    boundary = torch.tensor([own[5], own[60], own[150], own[230], 0],
                            dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, False])
    stars = []
    for d in ("cpu", dev):
        gd = G.PoseGraph(*(t.to(d) for t in (getattr(g, f.name) for f in
                                              dataclasses.fields(g))))
        order = CH.chain_order(vo.to(d), vr.to(d), gd.vmask)
        b, v = boundary.to(d), valid.to(d)
        gn.BAND_CALLS.clear()
        stars.append(CG.condense(gd, b, v, CG.select_gauge_centroid(gd, b, v),
                                 G.own_edge_mask(gd, 0), order))
        assert gn.BAND_CALLS == {("optimize_auto", band): 1,
                                 ("marginal_covariance_auto", band): 1}
    want, got = stars
    assert torch.equal(got.valid.cpu(), want.valid)
    keep = want.valid
    torch.testing.assert_close(got.z.cpu()[keep], want.z[keep], rtol=0,
                               atol=1e-4)
    w = want.info[keep]
    torch.testing.assert_close(got.info.cpu()[keep], w, rtol=2e-2,
                               atol=2e-2 * float(w.abs().max()))


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
    launches = [k.launches for k in (K.SCORE_VOLUME, K.PROBE_NO_GATHER,
                                     K.PROBE_CONST_CELLS)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, info = S.keyframe_step(slam.state, est, ranges, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(state.graph.n_vertices) == 14
    assert np.isfinite(float(info.chi2))
    # three K1 launches (close, near, loop), no probe
    assert [K.SCORE_VOLUME.launches, K.PROBE_NO_GATHER.launches,
            K.PROBE_CONST_CELLS.launches] == [launches[0] + 3] + launches[1:]


# --- fixed-order float sums in the solver: bit-identical repeats ---------
#
# Every float sum over edges on the solve path (dense assembly; the chain
# band's D, L, b and its matrix-free product; the PCG band's b, diagonal,
# preconditioner band L and Hessian-vector product) adds in one fixed
# order, so repeating a call on the same inputs on the card gives the same
# bits. (``index_add_`` added them with atomics, whose order changes from
# run to run.)

REPEATS = 20
FIXTURE = Path(__file__).parent / "fixtures" / "merged_2robot_1024.npz"


def _repeats_identical(fn, n=REPEATS):
    """Call ``fn`` ``n`` times; every output tensor equal bit for bit to
    the first call's (and finite)."""
    first = fn()
    first = first if isinstance(first, tuple) else (first,)
    torch.cuda.synchronize()
    for t in first:
        assert bool(torch.isfinite(t).all())
    for k in range(1, n):
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        for a, b in zip(first, out):
            assert torch.equal(a, b), (k, float((a - b).abs().max()))


def _merged(dev):
    """The merged two-robot graph at capacity 1024 (plain numpy) on the
    card, permuted into chain order, and its slot permutation."""
    from cg_mrslam_tpu_torch.core import graph as G
    from cg_mrslam_tpu_torch.solver import chain as CH

    d = np.load(FIXTURE)
    g = G.PoseGraph(*(torch.as_tensor(d[f]).to(dev) for f in (
        "poses", "vmask", "fixed", "e_ij", "e_z", "e_info", "emask",
        "e_level", "e_owner", "n_vertices", "n_edges")))
    order = CH.chain_order(torch.as_tensor(d["v_owner"]).to(dev),
                           torch.as_tensor(d["v_remote"]).to(dev), g.vmask)
    return g, order


@pytest.fixture(scope="module")
def live_graph():
    """A live ``srslam`` graph on the card (40 keyframes, capacity 128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from cg_mrslam_tpu_torch.config import Config, MatcherConfig
    from cg_mrslam_tpu_torch.pipeline import slam as S
    from cg_mrslam_tpu_torch.sim import world as W

    cfg = Config(close_matcher=MatcherConfig(extent=16.0, resolution=0.05,
                                             kernel_radius=0.2),
                 lc_matcher=MatcherConfig(extent=24.0, resolution=0.1,
                                          kernel_radius=0.5),
                 max_vertices=128, max_edges=512)
    traj = W.simulate_robot(W.hospital_world(16.0, 10.0, seed=2),
                            W.corridor_waypoints(16.0, 10.0, 0, 2), seed=5,
                            beams=120, max_range=8.0, device="cuda")
    slam = S.SingleRobotSlam(cfg, 120, traj.gt[0], traj.ranges[0],
                             fov=1.5 * math.pi, max_range=8.0, device="cuda")
    t = 1
    while len(slam.infos) < 40:
        slam.observe(traj.rel_odom[t - 1], traj.ranges[t])
        t += 1
    return slam.state


def test_dense_assembly_repeats_bit_for_bit(dev, live_graph):
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn

    def build(g):
        return lambda: tuple(gn.build_normal_equations(g))

    _repeats_identical(build(live_graph.graph))
    g, _ = _merged(dev)
    _repeats_identical(build(g))


def test_chain_assembly_and_product_repeat_bit_for_bit(dev, live_graph):
    from cg_mrslam_tpu_torch.core.graph import permute_vertices
    from cg_mrslam_tpu_torch.solver import chain as CH

    g, order = _merged(dev)
    for gp in (permute_vertices(g, order), live_graph.graph):
        def assemble():
            td, b, _, _ = CH._assemble(gp, None, 64)
            return td.D, td.Dt, td.L, b

        _repeats_identical(assemble)
        td, _, loops, _ = CH._assemble(gp, None, 64)
        x = torch.randn((8,) + gp.poses.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
        _repeats_identical(lambda: CH._h_matvec(td, loops, x))


def test_pcg_assembly_and_product_repeat_bit_for_bit(dev, live_graph):
    from cg_mrslam_tpu_torch.core.graph import permute_vertices
    from cg_mrslam_tpu_torch.solver import pcg as P

    g, order = _merged(dev)
    for gp in (permute_vertices(g, order), live_graph.graph):
        gen = torch.Generator(dev).manual_seed(1)
        r = torch.randn((8,) + gp.poses.shape, device=dev, generator=gen)
        x = torch.randn((8,) + gp.poses.shape, device=dev, generator=gen)

        def factorize():
            f = P._factorize(gp, None)
            # the preconditioner's band L enters through its solve
            return f.b, f.diag, P._tridiag_precond(gp, f)(r)

        _repeats_identical(factorize)
        f = P._factorize(gp, None)
        _repeats_identical(lambda: P._hvp(gp, f, x))


def test_pcg_band_solve_repeats_bit_for_bit(dev):
    """A whole PCG-band solve and marginal solve (the merged graph is not
    chainable: PCG under the chain order)."""
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn

    g, order = _merged(dev)
    query = torch.arange(100, 1000, 60, dtype=torch.int32, device=dev)
    gn.BAND_CALLS.clear()
    _repeats_identical(lambda: gn.optimize_auto(g, order=order).poses)
    _repeats_identical(lambda: gn.marginal_covariance_auto(g, query,
                                                           order=order))
    assert set(gn.BAND_CALLS) == {("optimize_auto", "pcg"),
                                  ("marginal_covariance_auto", "pcg")}


def test_occupancy_on_the_card_matches_cpu(dev, live_graph):
    """``integrate`` on the card against the CPU on a live graph: the same
    totals, ≤ 0.1% of the cells off, each by at most two samples (the card
    fuses ``origin + dir·t`` into one rounding, the CPU rounds twice: a
    sample within an ulp of a cell boundary can change cell), the same
    chunked or not."""
    from cg_mrslam_tpu_torch.maps import occupancy as OCC

    st = live_graph
    kw = dict(cells=384, resolution=0.05, max_range=8.0,
              infinity_filling_range=5.0)
    center = torch.tensor([8.0, 5.0])
    got = OCC.integrate(st.graph.poses, st.scans, center.to(dev), **kw)
    cpu = [_to_cpu(st.graph).poses, _to_cpu(st.scans)]
    want = OCC.integrate(cpu[0], cpu[1], center, **kw)
    for a, b, unit in ((got.hits, want.hits, 3.0),
                       (got.misses, want.misses, 1.0)):
        a, b = a.cpu().numpy(), b.numpy()
        assert a.sum() == b.sum() > 0
        d = np.abs(a - b)
        assert (d > 0).mean() <= 1e-3 and d.max() <= 2 * unit
    assert bool((OCC.threshold(got) == OCC.OCCUPIED).any())


def _to_cpu(obj):
    import dataclasses

    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).cpu() for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})
