"""Card-only tests of the PyTorch/CUDA port: the score-volume kernels K1
and K2 (and K2's fused ``known_cap`` pair) against their plain version — at
the main path's shapes and at edge cases, bit-identical on repeat, exact
ties kept —, the timing probes against theirs and kept off the main path,
their launch counts and input checks, the solver's masked loops and
condense on the card against the CPU, a keyframe step with no host
synchronization, the solver's float sums repeated bit for bit (summed with
``index_add_``, these repeats differed), and the occupancy map on the card
against the CPU, and two robot nodes on the card (K1 three times a
keyframe, K2's pair per global search, no probe) whose messages decode onto
the card as on the CPU; K2's single-grid entry at the lattices of
``global_match`` and ``loop_closure_match_hierarchical``, ``global_match``
on the card against the CPU, the visibility gate adding no host sync, and
cells on the card equal to the CPU's for points on cell edges; the solves
over a batch of graphs (dense, chain, PCG bands) repeated bit for bit,
against the CPU's, and with as many host reads for 64 graphs as for 2;
a batched PCG solve's host syncs, each one a host read the solver counts
but one named copy, and its spans adding no kernel; the PCG band's
Hessian-vector kernel pair against its plain version at the benchmark's
shapes and with 3Q marginal columns, bit-equal per graph under a permuted
batch, and launched once per CG iteration; the preconditioner's
cyclic-reduction kernel (``csrc/cr_apply.cu``) against its plain version
at the benchmark's shapes, the star's, a chain band's ``Hc⁻¹U`` and in
float64, bit-equal on repeat and per graph under a permuted batch, and
launched once per solve; the PCG loop's update kernels
(``csrc/cg_update.cu``) against their plain version and bit for bit
against the CPU rehearsal of their arithmetic, at the benchmark's shapes,
the star's and a split 65,536-pose system, with frozen systems untouched,
in a CG loop whose captured replay equals the loop as written, and in
whole PCG solves; the benchmark cell's optimal-gauge star (128
candidates on the merged fixture) against the plain float64 oracle run on
the card.
Every test carries the ``cuda`` marker and skips where there is no NVIDIA
GPU.

This file imports neither JAX nor ``cg_mrslam_tpu``, so it also runs on a
machine without them (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    PYTHONPATH=. python -m pytest --noconftest -o addopts= -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import dataclasses
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
        want = masked_loop(body, (x0, n0), budget, "test")
        got = masked_loop(body, (x0.to(dev), n0.to(dev)), budget, "test")
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(got[1].cpu(), want[1])
        assert int(want[1].min()) < 24 and int(want[1].max()) == budget


def test_graphed_masked_loop_matches_the_plain_loop(dev):
    """``masked_loop(..., graph=True)`` on the card, its stretches after
    the first replayed as one captured graph: the same exit iteration
    and the same state as the loop as written, bit for bit, where the
    looks stop it, where the budget does, and where the budget is not a
    multiple of the look's stride (the tail runs as written)."""
    from cg_mrslam_tpu_torch.solver.spd import masked_loop

    stops = torch.tensor([3, 9, 17, 40], device=dev)

    def body(s):
        k, x = s
        go = k + 1 <= stops
        return (k + 1, torch.where(go, 0.9 * x + 0.2, x)), go

    x0 = torch.linspace(-3.0, 5.0, 4, device=dev)
    for budget in (64, 61, 20, 8):
        k0 = torch.zeros((), dtype=torch.long, device=dev)
        want = masked_loop(body, (k0, x0), budget, "test")
        got = masked_loop(body, (k0, x0), budget, "test", graph=True)
        assert int(got[0]) == int(want[0]) == min(budget, 48)
        assert torch.equal(got[1], want[1])
        assert torch.equal(x0, torch.linspace(-3.0, 5.0, 4, device=dev))


def test_graphed_pcg_settle_and_marginals_match_the_plain_loops(dev):
    """A batched GN×1 and marginal solve on the PCG band with their CG
    iterations replayed as captured graphs (``cg_graph``, as a condense
    runs them) give the poses and covariances of the plain loops, bit for
    bit: the same kernels in the same order. 44 iterations: five replayed
    stretches after the first and a tail of four; and again at a budget
    the settle's tolerance ends. The preconditioner's kernel runs in
    both."""
    from cg_mrslam_tpu_torch.ops.cr_apply import CR_APPLY
    from cg_mrslam_tpu_torch.sim.graphs import build_merged_batch
    from cg_mrslam_tpu_torch.solver import pcg as P

    g, order, _ = build_merged_batch(8, device=dev)
    before = CR_APPLY.launches
    for cg_iters in (44, 400):
        want = P.optimize_pcg(g, 1, order=order, cg_iters=cg_iters).poses
        got = P.optimize_pcg(g, 1, order=order, cg_iters=cg_iters,
                             cg_graph=True).poses
        assert torch.equal(got, want)
    settle = CR_APPLY.launches
    assert settle > before
    g = dataclasses.replace(g, poses=want)
    q = torch.arange(100, 300, 25, device=dev)
    want = P.marginal_covariance_pcg(g, q, cg_iters=44, order=order)
    got = P.marginal_covariance_pcg(g, q, cg_iters=44, order=order,
                                    cg_graph=True)
    assert torch.equal(got, want)
    assert CR_APPLY.launches > settle


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
        from cg_mrslam_tpu_torch.ops.pcg_hvp import PCG_HVP

        before = PCG_HVP.launches
        _repeats_identical(lambda: P._hvp(gp, f, x))
        assert PCG_HVP.launches == before + REPEATS


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


# The PCG band's Hessian-vector kernel pair (csrc/pcg_hvp.cu) against its
# plain version: each row within 1e-5 of its Σ|Jᵀ||Ω||J||x| (the two sum
# in other orders and the card contracts products into FMAs: about twenty
# float32 roundings a term, ~1e-6 of that scale; 1e-5 leaves room).
HVP_REL = 1e-5


def _hvp_close(g, f, x, rel=HVP_REL):
    from cg_mrslam_tpu_torch.ops.pcg_hvp import PCG_HVP
    from cg_mrslam_tpu_torch.solver import pcg as P

    before = PCG_HVP.launches
    got = P._hvp(g, f, x)
    assert PCG_HVP.launches == before + 1
    want = P._hvp_plain(g, f, x)
    fa = f._replace(Ji=f.Ji.abs(), Jj=f.Jj.abs(), omega=f.omega.abs())
    bar = rel * P._hvp_plain(g, fa, x.abs())
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs()
    assert bool((err <= bar).all()), float((err - bar).max())
    return got


def _first(g):
    return dataclasses.replace(g, **{f.name: getattr(g, f.name)[0]
                                     for f in dataclasses.fields(g)})


def test_pcg_hvp_kernel_matches_plain(dev):
    """At ``fleet_pcg``'s shapes (2048 merged graphs under the chain
    order, one column), at a batch-1 call with 3Q = 48 columns, and in
    float64 (1e-12)."""
    from cg_mrslam_tpu_torch.core.graph import permute_vertices
    from cg_mrslam_tpu_torch.sim.graphs import build_merged_batch
    from cg_mrslam_tpu_torch.solver import pcg as P

    g, order, _ = build_merged_batch(2048, device=dev)
    g = permute_vertices(g, order)
    gen = torch.Generator(dev).manual_seed(3)
    f = P._factorize(g, None)
    _hvp_close(g, f, torch.randn(g.poses.shape, device=dev, generator=gen))
    one = _first(g)
    f1 = P._factorize(one, None)
    _hvp_close(one, f1, torch.randn((48,) + one.poses.shape, device=dev,
                                    generator=gen))
    g64 = dataclasses.replace(one, **{k: getattr(one, k).double()
                                      for k in ("poses", "e_z", "e_info")})
    _hvp_close(g64, P._factorize(g64, None),
               torch.randn((6,) + one.poses.shape, device=dev,
                           generator=gen, dtype=torch.float64), rel=1e-12)


def test_pcg_hvp_kernel_per_graph_under_permuted_batch(dev):
    """The kernel's result for a graph does not depend on its place in
    the batch or its batch-mates: the same factors, permuted, give the
    permuted product bit for bit."""
    from cg_mrslam_tpu_torch.core.graph import permute_vertices
    from cg_mrslam_tpu_torch.sim.graphs import build_merged_batch
    from cg_mrslam_tpu_torch.solver import pcg as P

    g, order, _ = build_merged_batch(16, device=dev)
    g = permute_vertices(g, order)
    f = P._factorize(g, None)
    x = torch.randn((16, 3) + g.poses.shape[1:], device=dev,
                    generator=torch.Generator(dev).manual_seed(4))
    perm = torch.randperm(16, generator=torch.Generator().manual_seed(5)
                          ).to(dev)
    gp = dataclasses.replace(g, **{k.name: getattr(g, k.name)[perm]
                                   for k in dataclasses.fields(g)})
    fp = f._replace(Ji=f.Ji[perm], Jj=f.Jj[perm], omega=f.omega[perm],
                    free=f.free[perm], segs=P._edge_table(gp, None))
    assert torch.equal(P._hvp(gp, fp, x[perm]), P._hvp(g, f, x)[perm])


def test_pcg_hvp_kernel_launches_once_per_cg_iteration(dev, monkeypatch):
    """A batched PCG solve and a batched marginal solve launch the kernel
    pair once per CG iteration they run (``loop.pcg.*.iters``), and
    nothing else of the band launches it."""
    from cg_mrslam_tpu_torch.ops.pcg_hvp import PCG_HVP
    from cg_mrslam_tpu_torch.sim.graphs import build_merged_batch
    from cg_mrslam_tpu_torch.solver import pcg as P
    from cg_mrslam_tpu_torch.utils import metrics as M

    g, order, _ = build_merged_batch(8, device=dev)
    monkeypatch.setattr(M, "_profiling", lambda: True)
    M.reset()
    before = PCG_HVP.launches
    out = P.optimize_pcg(g, 3, order=order, cg_iters=24)
    P.marginal_covariance_pcg(out, torch.arange(100, 200, 25, device=dev),
                              cg_iters=40, order=order)
    c = M.counts()
    M.reset()
    assert c["loop.pcg.cg.iters"] > 0 and c["loop.pcg.marginal.iters"] > 0
    assert PCG_HVP.launches - before == (c["loop.pcg.cg.iters"]
                                         + c["loop.pcg.marginal.iters"]), c


# The preconditioner's cyclic-reduction kernel (csrc/cr_apply.cu) against
# its plain version (ops/cr_apply.cr_apply_plain). The two sum in other
# orders and the card contracts products into FMAs; a solve amplifies
# rounding by T's condition, so each is held to the same factor's solve in
# float64: the kernel's error at most twice the plain version's (and 1e-6
# of the answer's scale). In float64 the two agree within 1e-9 of it.


def _cr_close(fact, r, free=None):
    from cg_mrslam_tpu_torch.ops import cr_apply as CA

    before = CA.CR_APPLY.launches
    got = CA.CR_APPLY(fact, r, free)
    assert CA.CR_APPLY.launches == before + 1
    want = CA.cr_apply_plain(fact, r, free)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    scale = float(want.abs().max())
    if r.dtype == torch.float64:
        assert float((got - want).abs().max()) <= 1e-9 * scale
        return got
    f64 = dataclasses.replace(fact, packed=fact.packed.double())
    exact = CA.cr_apply_plain(f64, r.double(), free)
    err_k = float((got.double() - exact).abs().max())
    err_p = float((want.double() - exact).abs().max())
    assert err_k <= 2 * err_p + 1e-6 * scale, (err_k, err_p, scale)
    return got


def _pcg_factor(g):
    from cg_mrslam_tpu_torch.solver import pcg as P

    f = P._factorize(g, None)
    return P._tridiag_factor(g, f), f.free


def _first_k(g, k):
    return dataclasses.replace(g, **{f.name: getattr(g, f.name)[:k]
                                     for f in dataclasses.fields(g)})


def test_cr_apply_kernel_matches_plain(dev):
    """At ``fleet_pcg``'s shapes (2048 merged graphs under the chain order,
    one column, the frozen vertices masked), at the star's (128 graphs,
    384 columns), at a batch-1 chain band's ``Hc⁻¹U`` (its 3M columns
    last), on a graph too long for shared memory (65,536 poses), and in
    float64."""
    from cg_mrslam_tpu_torch.core.graph import permute_vertices
    from cg_mrslam_tpu_torch.ops import cr_apply as CA
    from cg_mrslam_tpu_torch.sim.graphs import (build_hospital_batch,
                                                build_merged_batch)
    from cg_mrslam_tpu_torch.solver import chain as CH
    from cg_mrslam_tpu_torch.solver import cyclic_reduction as CR

    gen = torch.Generator(dev).manual_seed(6)
    g, order, _ = build_merged_batch(2048, device=dev)
    g = permute_vertices(g, order)
    fact, free = _pcg_factor(g)
    assert not bool(free.all())
    r = torch.randn((2048, 1) + g.poses.shape[1:], device=dev, generator=gen)
    _cr_close(fact, r, free)
    star = _first_k(g, 128)
    del g, fact
    fact, free = _pcg_factor(star)
    r = torch.randn((128, 384) + star.poses.shape[1:], device=dev,
                    generator=gen)
    _cr_close(fact, r, free)
    del r
    one = _first(build_hospital_batch(1, n=1024, closures=48, device=dev))
    td, _, loops, _ = CH._assemble(one, None, 64)
    fact1 = CR.cr_factor(td.D, td.L)
    u = loops[-1]                                            # [N, 3, 3M]
    before = CA.CR_APPLY.launches
    got = CR.cr_apply(fact1, u)
    assert CA.CR_APPLY.launches == before + 1 and got.shape == u.shape
    want = _cr_close(fact1, u.movedim(-1, -3)[None])
    assert torch.equal(got, want[0].movedim(-3, -1))
    ring = _first(build_hospital_batch(1, n=65536, closures=16, device=dev))
    fact, free = _pcg_factor(ring)
    assert CA.buffer_elems(fact.m, 1) * 4 > 232448          # device memory
    _cr_close(fact, torch.randn((1, 1) + ring.poses.shape, device=dev,
                                generator=gen), free[None])
    g64 = _first_k(star, 4)
    g64 = dataclasses.replace(g64, **{k: getattr(g64, k).double()
                                      for k in ("poses", "e_z", "e_info")})
    fact, free = _pcg_factor(g64)
    _cr_close(fact, torch.randn((4, 6) + g64.poses.shape[1:], device=dev,
                                generator=gen, dtype=torch.float64), free)


def test_cr_apply_kernel_repeats_and_is_per_graph(dev):
    """Bit-equal on repeat, at one column and at many; a graph's result
    does not depend on its place in the batch or its batch-mates."""
    from cg_mrslam_tpu_torch.core.graph import permute_vertices
    from cg_mrslam_tpu_torch.ops import cr_apply as CA
    from cg_mrslam_tpu_torch.sim.graphs import build_merged_batch

    g, order, _ = build_merged_batch(16, device=dev)
    g = permute_vertices(g, order)
    fact, free = _pcg_factor(g)
    gen = torch.Generator(dev).manual_seed(7)
    for cols in (1, 24):
        r = torch.randn((16, cols) + g.poses.shape[1:], device=dev,
                        generator=gen)
        _repeats_identical(lambda: CA.CR_APPLY(fact, r, free))
        perm = torch.randperm(16, generator=torch.Generator().manual_seed(
            cols)).to(dev)
        fp = dataclasses.replace(fact, packed=fact.packed[perm].contiguous())
        assert torch.equal(CA.CR_APPLY(fp, r[perm], free[perm].contiguous()),
                           CA.CR_APPLY(fact, r, free)[perm])


def test_cr_apply_kernel_launches_once_per_solve(dev, monkeypatch):
    """A batched PCG solve and a batched marginal solve launch the kernel
    once per preconditioner solve: once per CG iteration they run
    (``loop.pcg.*.iters``) and once before each CG loop (one a GN
    iteration, one a marginal solve)."""
    from cg_mrslam_tpu_torch.ops.cr_apply import CR_APPLY
    from cg_mrslam_tpu_torch.sim.graphs import build_merged_batch
    from cg_mrslam_tpu_torch.solver import pcg as P
    from cg_mrslam_tpu_torch.utils import metrics as M

    g, order, _ = build_merged_batch(8, device=dev)
    monkeypatch.setattr(M, "_profiling", lambda: True)
    M.reset()
    before = CR_APPLY.launches
    out = P.optimize_pcg(g, 3, order=order, cg_iters=24)
    P.marginal_covariance_pcg(out, torch.arange(100, 200, 25, device=dev),
                              cg_iters=40, order=order)
    c = M.counts()
    M.reset()
    assert c["gn.iters.pcg"] == 3 and c["loop.pcg.marginal.iters"] > 0
    assert CR_APPLY.launches - before == (
        c["loop.pcg.cg.iters"] + c["gn.iters.pcg"]
        + c["loop.pcg.marginal.iters"] + 1), c


# The PCG loop's vector updates (csrc/cg_update.cu) against their plain
# version (ops/cg_update.py) and, bit for bit, against the CPU rehearsal
# of their arithmetic (tests/test_torch_cg_update.py: the same IEEE
# operations in the same order): tools/bench_cg_update.check, whose
# bound on the sums' order is 1e-5 of the scale in float32 and 1e-12 in
# float64.


def test_cg_update_kernels_match_plain_and_rehearsal(dev):
    """At ``fleet_pcg``'s shapes (2048 graphs of 1024 slots, one system
    each), at the star's (128 graphs × 384 columns of 1024 slots; the
    rehearsal on the first graph's columns), on a batch-1 65,536-pose
    system (64 blocks: the split path) and in float64."""
    from cg_mrslam_tpu_torch.ops import cg_update as CU
    from tools.bench_cg_update import CHECKS, check

    assert CU.plan(3 * 1024).chunks == 1 and CU.plan(3 * 65536).chunks > 1
    for lead, n, dt, seed, graphs, rehearse in CHECKS:
        check(lead, n, getattr(torch, dt), seed, graphs, rehearse, dev)
        torch.cuda.empty_cache()


def test_cg_loop_kernels_freeze_and_replay(dev):
    """The CG loop with the kernels on small SPD systems that freeze at
    several iterations, some at the first (``tests/
    test_torch_cg_update._problem``): a frozen system's ``x`` stays bit for
    bit; ``pcg._masked_pcg``'s captured replay (``graph=True``) equals the
    loop as written bit for bit; and the card's ``x`` is within 1e-4 of
    the CPU's plain loop (a system whose residual sits at the tolerance
    may freeze an iteration apart: one step, ~√tol / λmin; 4e-6 measured
    between the plain version and the rehearsal on the CPU)."""
    from test_torch_cg_update import _problem

    from cg_mrslam_tpu_torch.ops import cg_update as CU
    from cg_mrslam_tpu_torch.solver import pcg as P

    for dtype, tol in ((torch.float32, 1e-9), (torch.float64, 1e-14)):
        hvp, pre, rhs, free = _problem(dtype, (8, 16), 40)
        want = P._masked_pcg(hvp, pre, rhs, pre(rhs), free, 64, tol,
                             "test.cpu", "test", False, False, 1e-6)
        hvp, pre, rhs, free = _problem(dtype, (8, 16), 40, device=dev)
        outs = []
        for graph in (False, True, False):
            before = CU.CG_UPDATE.launches
            outs.append(P._masked_pcg(hvp, pre, rhs, pre(rhs), free, 64, tol,
                                      "test.card", "test", graph, False,
                                      1e-6))
            if not graph:
                assert CU.CG_UPDATE.launches - before == 2 * 64
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0],
                                                             outs[2])
        scale = float(want.abs().max())
        assert float((outs[0].cpu() - want).abs().max()) <= 1e-4 * scale

        x, r = torch.zeros_like(rhs), rhs.clone()
        p = pre(rhs)
        rz = CU.dot(rhs, p)
        active = torch.ones(rz.shape, dtype=torch.bool, device=dev)
        froze = torch.full(rz.shape, -1, device=dev)
        for k in range(64):
            was, x_was = active.clone(), x.clone()
            CU.cg_update_a(x, r, p, hvp(p), rz, active, free, 1e-6, tol,
                           False)
            CU.cg_update_b(r, pre(r), p, rz, active)
            froze[was & ~active] = k
            assert torch.equal(x[~was], x_was[~was])
        assert torch.equal(x, outs[0])
        stops = set(froze.flatten().tolist())
        assert 0 in stops and len(stops - {-1}) >= 3, stops


def test_pcg_solves_with_the_update_kernels_match_plain_updates(
        dev, monkeypatch):
    """Whole ``pcg_delta`` steps (``optimize_pcg``, GN×2) and
    ``marginal_covariance_pcg`` on 8 merged graphs, and one ``pcg_delta``
    on a batch-1 65,536-pose hospital ring (the split path), the update
    kernels against the plain updates on the card (the HVP and
    preconditioner kernels in both): in float64 within 1e-9 of the
    answers' scale, in float32 within 2e-3 (64 and 96 CG iterations, each
    moved in its last bits by the sums' order, which CG carries and a GN
    step's linearization amplifies). Each update kernel launches twice a
    CG iteration."""
    from cg_mrslam_tpu_torch.ops import cg_update as CU
    from cg_mrslam_tpu_torch.sim.graphs import (build_hospital_batch,
                                                build_merged_batch)
    from cg_mrslam_tpu_torch.solver import pcg as P
    from cg_mrslam_tpu_torch.utils import metrics as M

    g, order, _ = build_merged_batch(8, device=dev)
    q = torch.arange(100, 300, 25, device=dev)

    def solve(gr):
        poses = P.optimize_pcg(gr, 2, order=order, cg_iters=64).poses
        cov = P.marginal_covariance_pcg(
            dataclasses.replace(gr, poses=poses), q, cg_iters=96,
            order=order)
        return poses, cov

    def ring_step(gr):
        return (P.pcg_delta(gr, cg_iters=64),)

    def plain_a(x, r, p, hp, rz, active, free, sigma, tol, new_residual):
        return CU.update_a_plain(x, r, p, hp, rz, active, free, sigma, tol,
                                 new_residual)

    g64 = dataclasses.replace(g, **{k: getattr(g, k).double()
                                    for k in ("poses", "e_z", "e_info")})
    ring = _first(build_hospital_batch(1, n=65536, closures=16, device=dev))
    assert CU.plan(3 * 65536).chunks > 1
    for fn, gr, rel in ((solve, g, 2e-3), (solve, g64, 1e-9),
                        (ring_step, ring, 2e-3)):
        monkeypatch.setattr(M, "_profiling", lambda: True)
        M.reset()
        before = CU.CG_UPDATE.launches
        got = fn(gr)
        c = M.counts()
        M.reset()
        assert CU.CG_UPDATE.launches - before == 2 * (
            c["loop.pcg.cg.iters"] + c.get("loop.pcg.marginal.iters", 0)), c
        monkeypatch.setattr(P, "cg_update_a", plain_a)
        monkeypatch.setattr(P, "cg_update_b", CU.update_b_plain)
        want = fn(gr)
        monkeypatch.undo()
        for a, b in zip(got, want):
            assert bool(torch.isfinite(a).all())
            assert float((a - b).abs().max()) <= rel * float(b.abs().max())

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


class _Loopback:
    """In-memory datagrams between ``n`` robots (the nodes' transport
    interface: ``send``, ``drain``, ``close``)."""

    def __init__(self, n):
        self.queues = [[] for _ in range(n)]

    def endpoint(self, robot):
        net = self

        class End:
            def send(self, peer, data):
                net.queues[peer].append(bytes(data))
                return True

            def drain(self, limit=256):
                q = net.queues[robot]
                out, q[:] = q[:limit], q[limit:]
                return out

            def close(self):
                pass

        return End()


@pytest.fixture(scope="module")
def node_run():
    """Two robot nodes on the card over a loopback network, 120 ticks of
    the small two-robot world (capacity 96). Returns the nodes, the
    kernels' launch counts of the run, K2's by shape and the number of
    comm rounds the two nodes ran together."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from cg_mrslam_tpu_torch.config import (Config, MatcherConfig, MRConfig,
                                            SlamConfig)
    from cg_mrslam_tpu_torch.mr.node import RobotNode
    from cg_mrslam_tpu_torch.sim import world as W

    cfg = Config(
        slam=SlamConfig(min_inliers=4, window_loop_closure=8),
        mr=MRConfig(n_robots=2, min_inliers_mr=4, sim_comm_range=6.0,
                    max_score_mr=0.2),
        close_matcher=MatcherConfig(extent=16.0, resolution=0.05,
                                    kernel_radius=0.2),
        lc_matcher=MatcherConfig(extent=24.0, resolution=0.1,
                                 kernel_radius=0.5),
        max_vertices=96, max_edges=512)
    fov = 1.5 * math.pi
    world = W.hospital_world(16.0, 10.0, seed=2)
    trajs = [W.simulate_robot(world, W.corridor_waypoints(16.0, 10.0, r, 2),
                              seed=11 + 7 * r, beams=120, fov=fov,
                              max_range=8.0, odom_noise=(0.02, 0.008),
                              device="cuda") for r in range(2)]
    net = _Loopback(2)
    nodes = [RobotNode(cfg, r, 120, trajs[r].gt[0], trajs[r].ranges[0], fov,
                       8.0, net.endpoint(r), modality="real",
                       gt_pose=trajs[r].gt[0]) for r in range(2)]
    counters = (K.SCORE_VOLUME, K.SCORE_VOLUME_STRIDED, K.PROBE_NO_GATHER,
                K.PROBE_CONST_CELLS)
    before = [k.launches for k in counters]
    pair_before = dict(K.SCORE_VOLUME_STRIDED.launches_by_shape)
    rounds = 0
    for t in range(1, 120):
        kfs = [n.observe(trajs[r].rel_odom[t - 1], trajs[r].ranges[t],
                         gt_pose=trajs[r].gt[t])
               for r, n in enumerate(nodes)]
        if any(kfs):
            for dt in (0.0, 0.05):
                for n in nodes:
                    n.comm_round(0.1 * t + dt)
                    rounds += 1
    torch.cuda.synchronize()
    launches = [k.launches - b for k, b in zip(counters, before)]
    pairs = {k: v - pair_before.get(k, 0) for k, v in
             K.SCORE_VOLUME_STRIDED.launches_by_shape.items()
             if v != pair_before.get(k, 0)}
    return nodes, launches, pairs, rounds


def test_robot_node_on_the_card_launches_its_kernels(node_run):
    """A node's keyframe launches K1 three times; every global search
    (one per keyframe and one per comm round) launches K2's fused pair
    once per level (4); no probe runs; the nodes exchanged and merged."""
    nodes, (k1, k2, p1, p2), pairs, rounds = node_run
    kf = sum(n.stats["keyframes"] for n in nodes)
    assert kf > 10 and rounds > 10
    assert k1 == 3 * kf, (k1, kf)
    assert k2 == 4 * (kf + rounds), (k2, kf, rounds)
    assert all(k[1] == 2 and len(k) == 7 for k in pairs), pairs
    assert p1 == 0 and p2 == 0
    for r, n in enumerate(nodes):
        assert n.device.type == "cuda"
        assert n.stats["received"] > 0 and n.stats["decode_errors"] == 0
        st = n.state.slam
        assert bool((st.graph.vmask & (st.v_owner == 1 - r)).any())
        assert all(math.isfinite(i.chi2) for i in n.infos)


def test_wire_decode_on_the_card_equals_cpu(node_run):
    """Messages built from the card's state encode to the bytes of the same
    state on the CPU, and decode onto the card to the CPU's values."""
    from cg_mrslam_tpu_torch.mr import mrslam as MR
    from cg_mrslam_tpu_torch.mr import wire

    st = node_run[0][0].state
    peer = 1
    msgs = {"combo": MR.build_combo(st), "graph": MR.build_graph_msg(st),
            "list": MR.build_closure_list(st, peer, cap=16)}
    if bool(st.in_closures[peer].any()):
        msgs["star"] = MR.build_star(st, peer, cap=16)
    for name, msg in msgs.items():
        buf = wire.encode(msg, robot=0)
        cpu_msg = type(msg)(*(v.cpu() if torch.is_tensor(v) else v
                              for v in msg))
        assert wire.encode(cpu_msg, robot=0) == buf, name
        _, on_card = wire.decode(buf, device="cuda")
        _, on_cpu = wire.decode(buf, device="cpu")
        for a, b in zip(on_card, on_cpu):
            assert a.device.type == "cuda" and b.device.type == "cpu"
            assert torch.equal(a.cpu(), b), name


def test_two_processes_build_the_kernel_at_once(dev, tmp_path):
    """Two processes that build ``score_volume.cu`` into the same empty
    directory at once (as two robot processes on one card can at their
    first launch) each end with a library that loads and launches."""
    import os
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    code = ("import sys, torch; from pathlib import Path; "
            "from cg_mrslam_tpu_torch.ops import correlate as K; "
            "K.BUILD_DIR = Path(sys.argv[1]); K.load_library(); "
            "g = torch.rand(1, 64, 64, device='cuda'); "
            "i = torch.zeros(1, 1, 8, dtype=torch.int32, device='cuda'); "
            "v = K.SCORE_VOLUME(g, torch.zeros(1, dtype=torch.int32, "
            "device='cuda'), i + 20, i + 30, torch.ones(1, 1, 8, "
            "dtype=torch.bool, device='cuda'), torch.full((1, 1), 8.0, "
            "device='cuda'), 2, 2); torch.cuda.synchronize(); "
            "print('ok', float(v.sum()) > 0)")
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0 and out.strip() == "ok True", err[-2000:]
    assert len(list(tmp_path.glob("libscore_volume-*.so"))) == 1
    assert not list(tmp_path.glob("tmp*")), list(tmp_path.iterdir())


# --- the matcher's other modes: K2's single-grid entry -------------------
#
# global_match and loop_closure_match_hierarchical search without
# known_cap, so on the card every level of their hierarchical search is
# one launch of K2's single-grid entry (not the fused pair). Lattices (T,
# ny, nx, stride, batch) at the LC grid's 0.1 m: global level 0 at stride
# 8, the refine levels of 16 survivors at strides 4, 2, 1 (the
# hierarchical loop closure's refines at 2 and 1 have the same shapes), and
# the hierarchical loop closure's level 0 at stride 4.
SINGLE = [(33, 6, 12, 8, 1), (5, 2, 2, 4, 16), (5, 2, 2, 2, 16),
          (5, 2, 2, 1, 16), (21, 5, 5, 4, 1)]


@pytest.mark.parametrize("t,ny,nx,stride,bsz", SINGLE)
def test_single_grid_k2_at_matcher_shapes(dev, t, ny, nx, stride, bsz):
    grids, _, (ix, iy, keep, count) = _inputs(dev, t, 700, 0.1, bsz,
                                              seed=t + stride)
    grid = grids[:1].contiguous()
    gidx = torch.zeros(bsz, dtype=torch.int32, device=dev)
    before = K.SCORE_VOLUME_STRIDED.launches
    key = (bsz, t, 2 * ny + 1, 2 * nx + 1, stride, stride)
    by_key = K.SCORE_VOLUME_STRIDED.launches_by_shape[key]
    got = K.SCORE_VOLUME_STRIDED(grid, gidx, ix, iy, keep, count, ny, nx,
                                 stride, stride)
    assert K.SCORE_VOLUME_STRIDED.launches == before + 1
    assert K.SCORE_VOLUME_STRIDED.launches_by_shape[key] == by_key + 1
    want = K.volume_plain(grid, gidx, ix, iy, keep, count,
                          _lattice(ny, stride, dev), _lattice(nx, stride, dev))
    torch.cuda.synchronize()
    assert got.shape == key[:4]
    assert float((want.amax(2) - want.amin(2)).max()) > 100 * ATOL
    assert float((want.amax(3) - want.amin(3)).max()) > 100 * ATOL
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def _world_scan(pose, beams=240, fov=1.5 * math.pi, max_range=10.0):
    """A scan of the small hospital world from ``pose`` (CPU): points in
    the scan frame and their valid mask."""
    from cg_mrslam_tpu_torch.sim import world as W

    segs = W.hospital_world(16.0, 10.0, seed=2).as_tensor("cpu")
    r = W.raycast(segs, torch.as_tensor(pose, dtype=torch.float32), beams,
                  -fov / 2, fov / beams, max_range)
    a = -fov / 2 + fov / beams * torch.arange(beams, dtype=torch.float32)
    pts = torch.stack([r * torch.cos(a), r * torch.sin(a)], -1)
    return pts, r < max_range * 0.999


def test_global_match_on_the_card_matches_cpu(dev, monkeypatch):
    """``global_match`` on the same inputs on the card and on the CPU: the
    same pose (1e-4) and score (1e-5; the cells are the same bits on both,
    only the kernel's summation order differs), four launches of K2's
    single-grid entry, no pair, no probe, and the planted pose found."""
    from cg_mrslam_tpu_torch.config import MatcherConfig, SearchWindows
    from cg_mrslam_tpu_torch.matcher import matching as TM
    from cg_mrslam_tpu_torch.matcher import search as TS
    from cg_mrslam_tpu_torch.utils import se2

    seen = []

    def spy(*args):
        seen.append((args[0].shape[0], args[8], len(args) > 10
                     and args[10] is not None))
        return K.SCORE_VOLUME_STRIDED(*args)

    monkeypatch.setattr(TS, "SCORE_VOLUME_STRIDED", spy)
    cfg = MatcherConfig(extent=30.0, resolution=0.1, kernel_radius=0.5)
    pose_a = torch.tensor([8.0, 5.0, 0.1])
    true_b = torch.tensor([8.6, 4.7, 0.9])
    pts_a, va = _world_scan(pose_a)
    pts_b, vb = _world_scan(true_b)
    ref = se2.apply(pose_a, pts_a)
    guess = true_b + torch.tensor([1.0, 0.5, 0.6])
    args = (ref, va, pts_b, vb, guess)
    probes = [K.PROBE_NO_GATHER.launches, K.PROBE_CONST_CELLS.launches]
    before = K.SCORE_VOLUME_STRIDED.launches
    got = TM.global_match(*(a.to(dev) for a in args), cfg=cfg,
                          windows=SearchWindows())
    torch.cuda.synchronize()
    assert K.SCORE_VOLUME_STRIDED.launches == before + 4
    assert seen == [(1, 8, False), (1, 4, False), (1, 2, False),
                    (1, 1, False)], seen
    assert [K.PROBE_NO_GATHER.launches,
            K.PROBE_CONST_CELLS.launches] == probes
    want = TM.global_match(*args, cfg=cfg, windows=SearchWindows())
    torch.testing.assert_close(got.pose.cpu(), want.pose, rtol=0, atol=1e-4)
    torch.testing.assert_close(got.score.cpu(), want.score, rtol=0,
                               atol=1e-5)
    err = (got.pose.cpu() - true_b).abs()
    assert float(err[:2].max()) <= 0.1 + 1e-4 and float(err[2]) <= 0.025 + 1e-4


def _find_syncs():
    """``count_syncs`` of ``tools/find_torch_syncs.py``."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "tools" / \
        "find_torch_syncs.py"
    spec = importlib.util.spec_from_file_location("find_torch_syncs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.count_syncs


def test_gate_adds_no_host_sync(dev):
    """``try_match_parked`` with the visibility gate on synchronizes with the
    host exactly as often as with it off (counted by
    ``tools/find_torch_syncs.py``'s ``count_syncs``), and its outcome on the
    card equals the CPU's from the same state."""
    import dataclasses as dc

    from cg_mrslam_tpu_torch import convert
    from cg_mrslam_tpu_torch.config import (Config, MatcherConfig, MRConfig,
                                            SlamConfig)
    from cg_mrslam_tpu_torch.mr import mrslam as MR
    from cg_mrslam_tpu_torch.mr.sim import MultiRobotSim
    from cg_mrslam_tpu_torch.sim import world as W

    cfg = Config(
        slam=SlamConfig(min_inliers=4, window_loop_closure=8),
        mr=MRConfig(n_robots=2, min_inliers_mr=4, sim_comm_range=6.0,
                    max_score_mr=0.2),
        close_matcher=MatcherConfig(extent=16.0, resolution=0.05,
                                    kernel_radius=0.2),
        lc_matcher=MatcherConfig(extent=24.0, resolution=0.1,
                                 kernel_radius=0.5),
        max_vertices=192, max_edges=1024)
    sim = MultiRobotSim(cfg, W.hospital_world(width=16.0, height=10.0,
                                              seed=2),
                        beams=120, seed=11, n_loops=2, width=16.0,
                        height=10.0, device="cuda")
    parked = []        # robot 0 holding a parked vertex, before a round
    exchange = sim.exchange_round

    def recording(t, modality="sim"):
        st = MR.receive_combo(sim.states[0], MR.build_combo(sim.states[1]),
                              True)
        if not parked and bool(st.parked.any()):
            parked.append(st)
        exchange(t, modality)

    sim.exchange_round = recording
    sim.run(max_ticks=40)
    st = parked[0]
    count_syncs = _find_syncs()
    gated = dc.replace(cfg, mr=dc.replace(cfg.mr,
                                          detect_robot_in_range=True))
    counts = {}
    for name, c in (("off", cfg), ("on", gated)):
        MR.try_match_parked(st, c)          # warm: the kernel library
        out, where = count_syncs(lambda c=c: MR.try_match_parked(st, c))
        counts[name] = sum(where.values())
    assert counts["on"] == counts["off"], counts
    cpu = convert.mr_state_from_numpy(convert.to_numpy(st),
                                      torch.device("cpu"))
    want = MR.try_match_parked(cpu, gated)
    for f in ("parked", "park_age"):
        assert torch.equal(getattr(out, f).cpu(), getattr(want, f))
    assert torch.equal(out.peer_buf.mask.cpu(), want.peer_buf.mask)
    torch.testing.assert_close(out.slam.graph.poses.cpu(),
                               want.slam.graph.poses, rtol=0, atol=1e-4)


def _straddling(res, cells):
    """float32 offsets near multiples of ``res`` whose quotient by ``res``
    and product with ``1/res`` (what a CUDA division by a Python number
    computes) fall in different cells once ``cells/2`` is added."""
    rf = np.float32(res)
    inv = np.float32(1.0) / rf
    h = np.float32(cells / 2.0)
    out = []
    for k in range(-cells // 2 - 2, cells // 2 + 2):
        near = (np.asarray(np.float32(k * res)).view(np.int32)
                + np.arange(-64, 64, dtype=np.int32)).view(np.float32)
        near = near[np.isfinite(near)]    # bit steps below 0.0 are NaNs
        a = np.floor((near / rf).astype(np.float32) + h)
        b = np.floor((near * inv).astype(np.float32) + h)
        out.extend(near[a != b])
    return np.asarray(out, np.float32)


def test_cells_on_the_card_equal_the_cpus(dev):
    """Points land in the same cells on the card as on the CPU, so a search
    on the card and on the CPU scores the same cells: the division by the
    resolution is by a device tensor (``matcher.grid.over``; a CUDA
    division by a Python number multiplies by the reciprocal, and these
    quotients sit next to a cell edge), and the rotation's ``cos``/``sin``
    are rounded from float64 (``se2.cos_sin``; the card's float32 ``sin``
    and ``cos`` differ from the CPU's in the last bit for about a fifth of
    angles)."""
    from cg_mrslam_tpu_torch.matcher.grid import world_to_cell
    from cg_mrslam_tpu_torch.utils.se2 import cos_sin

    for res, cells in ((0.1, 700), (0.025, 1200)):
        y = _straddling(res, cells)
        assert len(y) > 0
        pts = torch.as_tensor(np.stack([y, y[::-1]], 1))
        zero = torch.zeros(2)
        want = world_to_cell(pts, zero, cells, res)
        got = world_to_cell(pts.to(dev), zero.to(dev), cells, res)
        assert torch.equal(got.cpu(), want)
        # the same points as a scan at the zero pose, θ = 0 (cos 1, sin 0)
        n = len(y)
        args = (torch.zeros(1, 2), res, cells, pts,
                torch.ones(1, n, dtype=torch.bool), torch.zeros(1, 3),
                torch.zeros(1))
        want = K.volume_cells(*args)
        got = K.volume_cells(*(a.to(dev) if torch.is_tensor(a) else a
                               for a in args))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    ang = torch.linspace(-4.0, 4.0, 100_003)
    for g, w in zip(cos_sin(ang.to(dev)), cos_sin(ang)):
        assert torch.equal(g.cpu(), w)


# ------------------------------------------------ the parallel layer


def test_sharded_solves_repeat_bit_for_bit(dev, tmp_path):
    """The edge-sharded dense and matrix-free solves of 64 loop graphs,
    one process on an NCCL mesh: two runs of each give the same bits (the
    assembly sums in a fixed order)."""
    from cg_mrslam_tpu_torch.parallel.launch import run_group
    import torch_dist_workers as workers

    (res,) = run_group(workers.card_sharded_repeats, 1, workdir=tmp_path,
                       backend="nccl", cuda_index=0, timeout=120.0)
    dense_a, dense_b, pcg_a, pcg_b = res
    assert np.isfinite(dense_a).all() and np.isfinite(pcg_a).all()
    np.testing.assert_array_equal(dense_a, dense_b)
    np.testing.assert_array_equal(pcg_a, pcg_b)


def _flat_close(a: dict, b: dict, atol=1e-4, rel=1e-6):
    """Integer and bool leaves equal; float leaves within ``atol`` plus
    ``rel`` of the leaf's largest magnitude (a star's information is
    ~1e4, where one float32 step is ~1e-3)."""
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if y.dtype == bool or np.issubdtype(y.dtype, np.integer):
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            scale = float(np.abs(y).max()) if y.size else 0.0
            np.testing.assert_allclose(x, y, rtol=0, atol=atol + rel * scale,
                                       err_msg=k)


def test_fleet_keyframe_round_on_the_card_matches_cpu(dev, monkeypatch):
    """One fleet round (both robots' keyframe steps and the exchange) from
    a state carried across from a card run of ``FleetSim``: on the card
    and on the CPU, integer leaves equal and floats within 1e-4 (+ 1e-6 of
    the leaf's scale)."""
    from cg_mrslam_tpu_torch import convert
    from cg_mrslam_tpu_torch.config import (Config, MatcherConfig, MRConfig,
                                            SlamConfig)
    from cg_mrslam_tpu_torch.parallel import fleet as F
    from cg_mrslam_tpu_torch.parallel import fleet_sim as FS
    from cg_mrslam_tpu_torch.sim import world as W

    cfg = Config(
        slam=SlamConfig(min_inliers=4, window_loop_closure=8),
        mr=MRConfig(n_robots=2, min_inliers_mr=4, sim_comm_range=6.0,
                    max_score_mr=0.2),
        close_matcher=MatcherConfig(extent=16.0, resolution=0.05,
                                    kernel_radius=0.2),
        lc_matcher=MatcherConfig(extent=24.0, resolution=0.1,
                                 kernel_radius=0.5),
        max_vertices=96, max_edges=512)
    calls = []
    real = FS.fleet_keyframe_round

    def recording(states, do, ests, ranges, conn, cfg_, nb, eb):
        calls.append((convert.tree_map(lambda a: a.cpu(), states),
                      np.array(do), ests.cpu(), ranges.cpu(), np.array(conn),
                      nb, eb))
        return real(states, do, ests, ranges, conn, cfg_, nb, eb)

    monkeypatch.setattr(FS, "fleet_keyframe_round", recording)
    fs = FS.FleetSim(cfg, W.hospital_world(16.0, 10.0, seed=2), beams=120,
                     seed=11, n_loops=2, device="cuda")
    fs.run(max_ticks=50)
    monkeypatch.undo()
    # the last round in which both robots stepped
    states, do, ests, ranges, conn, nb, eb = next(
        c for c in reversed(calls) if c[1].all())
    assert conn.any()
    out = {}
    for d in ("cpu", "cuda"):
        st = convert.tree_map(lambda a: a.to(d), states)
        new, info = real(st, do, ests.to(d), ranges.to(d), conn, cfg, nb, eb)
        out[d] = (convert.to_numpy(new), info.cpu().numpy())
    _flat_close(out["cuda"][0], out["cpu"][0])
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=0,
                               atol=1e-4 + 1e-6 * np.abs(out["cpu"][1]).max())
    lvl = out["cuda"][0]["slam.graph.e_level"]
    assert (lvl > 0).any()


# ------------------------------------------------ solves over a batch


def _batch_of(band, device):
    """A batch of the band's bench graphs on ``device``."""
    from cg_mrslam_tpu_torch.sim import graphs as GR

    if band.startswith("dense"):
        return GR.build_batch(64, device=device), None
    if band == "chain":
        return GR.build_hospital_batch(8, device=device), None
    g, order, _ = GR.build_merged_batch(8, device=device)
    return g, order


def _solve(band, g, order):
    from cg_mrslam_tpu_torch.solver import chain as CH
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn
    from cg_mrslam_tpu_torch.solver.pcg import optimize_pcg

    if band.startswith("dense"):
        return gn.optimize(g, 5, chol=band == "dense_chol").poses
    if band == "chain":
        return CH.optimize_chain(g, 5, loop_cap=64, cg_iters=24,
                                 cg_tol=1e-4).poses
    return optimize_pcg(g, 5, order=order, cg_iters=8).poses


BANDS = ["dense", "dense_chol", "chain", "pcg"]


@pytest.mark.parametrize("band", BANDS)
def test_batched_solves_repeat_bit_for_bit(dev, band):
    """Five batched solves of each band on the card give the same bits."""
    g, order = _batch_of(band, dev)
    first = _solve(band, g, order)
    assert bool(torch.isfinite(first).all())
    for _ in range(4):
        assert torch.equal(_solve(band, g, order), first), band


@pytest.mark.parametrize("band", BANDS)
def test_batched_solves_on_the_card_match_cpu(dev, band):
    """The card's batched solve against the CPU's, at the CPU tests' bars
    (``tests/test_torch_batched.py``): dense poses within 1e-4; chain: the
    median over the batch of each graph's largest distance from the exact
    optimum within 0.02 m and rad, then chi2 within 1%, or both below 1e-4
    of the start (converged: the float32 noise floor, where one graph's
    chi2 lands anywhere from 1e-6 to 1e-2 with the rounding); PCG chi2
    within 1%. Graph by graph, a float32 chain solve ends anywhere from
    0.002 to 0.05 from the optimum as the rounding goes, and about one in
    a hundred far off (over 128 graphs on the CPU: median 0.007, p90 0.017,
    p99 0.43), so only the median is held; medians of 8 graphs read 0.003
    to 0.014 on the CPU. The tight check of the chain band on the card is
    :func:`test_batched_chain_float64_on_the_card_matches_cpu`."""
    from cg_mrslam_tpu_torch.core.linearize import chi2
    from cg_mrslam_tpu_torch.sim.graphs import hospital_truth

    g, order = _batch_of(band, dev)
    gc, oc = _batch_of(band, "cpu")
    got, want = _solve(band, g, order).cpu(), _solve(band, gc, oc)
    if band.startswith("dense"):
        assert float(_pose_err(got, want).max()) <= 1e-4
        return
    if band == "chain":
        truth = torch.as_tensor(hospital_truth(got.shape[-2]))
        e_card, e_cpu = _pose_err(got, truth), _pose_err(want, truth)
        assert float(e_card.median()) <= 0.02, (e_card, e_cpu)
    c0 = chi2(gc).double()
    c1 = chi2(dataclasses.replace(gc, poses=got)).double()
    c2 = chi2(dataclasses.replace(gc, poses=want)).double()
    close = (c1 - c2).abs() <= 0.01 * c2
    if band == "chain":
        close |= torch.maximum(c1, c2) <= 1e-4 * c0
    assert bool(torch.all(close)), (c1, c2, c0)


def _pose_err(a, b):
    """Per graph, the largest pose difference (angles wrapped)."""
    d = (a.double() - b.double())
    d[..., 2] = torch.remainder(d[..., 2] + math.pi, 2 * math.pi) - math.pi
    return d.abs().flatten(-2).amax(-1)


def test_batched_chain_float64_on_the_card_matches_cpu(dev):
    """Five GN iterations of the chain band at the bench's operating point,
    in float64, on 8 bench hospital graphs with 12 loop closures: the
    card's poses within 1e-6 of the CPU's (``tests/test_torch_chain_f64.py``'s
    bar against the reference; with 12 closures the capacitance inverse
    converges on every graph, so rounding is all that differs)."""
    from cg_mrslam_tpu_torch.sim import graphs as GR
    from cg_mrslam_tpu_torch.solver import chain as CH

    out = {}
    for d in (dev, "cpu"):
        g = GR.build_hospital_batch(8, closures=12, device=d)
        g = dataclasses.replace(g, **{f: getattr(g, f).double()
                                      for f in ("poses", "e_z", "e_info")})
        out[d] = CH.optimize_chain(g, 5, loop_cap=64, cg_iters=24,
                                   cg_tol=1e-4).poses.cpu()
    err = _pose_err(out[dev], out["cpu"])
    assert bool(torch.all(err <= 1e-6)), err


def test_batched_chain_host_reads_with_closures(dev, monkeypatch):
    """Host synchronizations of a batched chain solve of 2 and of 64 bench
    hospital graphs (48 loop closures each, distinct noise) are equal, with
    every loop at a fixed count: CG to its whole budget (``cg_tol`` 0) and
    the capacitance inverse's Newton–Schulz polish at exactly 8 steps. So
    the Woodbury part of the batched path carries the check too."""
    import functools

    from cg_mrslam_tpu_torch.sim import graphs as GR
    from cg_mrslam_tpu_torch.solver import chain as CH
    from cg_mrslam_tpu_torch.solver import spd

    monkeypatch.setattr(CH, "spd_inverse", functools.partial(
        spd.spd_inverse, refine=8, max_refine=8))
    count_syncs = _find_syncs()
    counts = {}
    for b in (2, 64):
        g = GR.build_hospital_batch(b, device=dev)
        CH.optimize_chain(g, 5, loop_cap=64, cg_iters=24, cg_tol=0.0)
        _, where = count_syncs(lambda g=g: CH.optimize_chain(
            g, 5, loop_cap=64, cg_iters=24, cg_tol=0.0))
        counts[b] = sum(where.values())
    assert counts[2] == counts[64] > 0, counts


def test_batched_chain_host_reads_do_not_grow_with_batch(dev):
    """A batched chain solve of 2 and of 64 copies of one graph makes the
    same number of host synchronizations (``count_syncs`` under
    ``set_sync_debug_mode("warn")``): the segment table's width once, the
    masked loops' looks every 8 iterations, whatever the batch size. The
    loops run to fixed counts here, so that rounding (batched matmuls of
    another batch size round otherwise) cannot move an exit: CG to its
    whole budget (``cg_tol`` 0), and a pure odometry chain, whose
    capacitance matrix is the identity (its inverse's polish stops after
    its first two steps)."""
    from cg_mrslam_tpu_torch.sim import graphs as GR
    from cg_mrslam_tpu_torch.solver import chain as CH

    one = GR.build_hospital_batch(1, n=512, closures=0, device=dev)
    count_syncs = _find_syncs()
    counts = {}
    for b in (2, 64):
        g = dataclasses.replace(one, **{
            f: getattr(one, f).expand((b,) + getattr(one, f).shape[1:])
            .contiguous() for f in ("poses", "vmask", "fixed", "e_ij", "e_z",
                                    "e_info", "emask", "e_level", "e_owner",
                                    "n_vertices", "n_edges")})
        CH.optimize_chain(g, 5, loop_cap=64, cg_iters=24, cg_tol=0.0)
        _, where = count_syncs(lambda g=g: CH.optimize_chain(
            g, 5, loop_cap=64, cg_iters=24, cg_tol=0.0))
        counts[b] = sum(where.values())
    assert counts[2] == counts[64] > 0, counts


def test_pcg_solve_syncs_are_its_counted_host_reads(dev, monkeypatch):
    """Under the profiler, a batched PCG solve through ``optimize_auto``
    synchronizes with the host once for each host read the program counts
    (``host_read.*``: the CG loop's looks, the band split's predicate, the
    segment table's width) and once more at one place the test names: the
    band split's copy of the PCG graphs' indices to the card, a blocking
    host-to-device copy. The spans add no kernel: the same solve with the
    spans switched off launches as many."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from cg_mrslam_tpu_torch.sim import graphs as GR
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn
    from cg_mrslam_tpu_torch.utils import metrics as M
    from perfbench.lib import trace as TR

    g, order, _ = GR.build_merged_batch(8, device=dev)

    def traced(spans):
        M.reset()
        with monkeypatch.context() as m:
            if not spans:
                m.setattr(M, "_profiling", lambda: False)
            prof = TR.start()
            with torch.profiler.record_function(TR.TICK):
                gn.optimize_auto(g, 2, order=order, pcg_iters=16)
            t = TR.stop(prof)
        c = M.counts()
        M.reset()
        return t, c

    gn.optimize_auto(g, 2, order=order, pcg_iters=16)         # warm
    TR.warm()
    on, counts = traced(True)
    off, _ = traced(False)
    reads = {k: v for k, v in counts.items() if k.startswith("host_read.")}
    assert reads == {"host_read.pcg.cg": 2 * 16 // 8, "host_read.split": 1,
                     "host_read.segment_table": 1}, counts
    assert on.count_syncs() == sum(reads.values()) + 1
    assert off.count_syncs() == on.count_syncs()
    assert on.count_device("kernel") == off.count_device("kernel") > 0


def test_optimal_star_on_the_card_matches_the_oracle(dev):
    """The ``star_optimal`` benchmark cell's star: robot 0's own edges of
    the merged fixture (capacity 1024, 896 edge slots) with pose noise,
    the 128 newest robot-0 vertices of its inter-robot closures as the
    boundary and the candidates, by ``condense_optimal`` on the card,
    against ``tests/oracle_condense.py`` (float64, on the card). Bars, the
    cell's limits on the same quantities: each candidate's uncertainty
    rtol 1e-4, ``z`` 5e-4 (m, rad), each edge's Ω 1e-4 of its Frobenius
    norm: float32 CG at the condense's budgets against float64 on a
    3072-wide system (the cell's 13 calibration seeds read at most 8.3e-6,
    4.5e-5 and 2.2e-6); the gauge's regret in the oracle's uncertainties
    below 1e-4 (128 candidates hold near ties)."""
    import oracle_condense as oracle
    from test_torch_optimal_star import _merged_graph

    from cg_mrslam_tpu_torch.core import graph as G
    from cg_mrslam_tpu_torch.mr import condensed as CG
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn

    g, boundary, order = _merged_graph(seed=7, k=128)
    gd = G.PoseGraph(*(getattr(g, f.name).to(dev)
                       for f in dataclasses.fields(g)))
    own = G.own_edge_mask(gd, 0)
    valid = torch.ones(128, dtype=torch.bool, device=dev)
    gn.BAND_CALLS.clear()
    star, u = CG.condense_optimal(gd, boundary.to(dev), valid, own,
                                  order.to(dev))
    assert gn.BAND_CALLS == {("optimize_auto", "pcg"): 128,
                             ("marginal_covariance_auto", "pcg"): 128}
    host = {k: getattr(g, k).numpy() for k in ("poses", "vmask", "e_ij",
                                               "e_z", "e_info")}
    want_u, best, _ = oracle.optimal(host, own.cpu().numpy(),
                                     boundary.numpy(), np.ones(128, bool),
                                     device=dev)
    u = u.cpu().double().numpy()
    np.testing.assert_allclose(u, want_u, rtol=1e-4)
    k = int(np.flatnonzero(boundary.numpy() == int(star.gauge))[0])
    assert want_u[k] / want_u.min() - 1.0 < 1e-4
    wz, wom, wvalid = oracle.star(host, own.cpu().numpy(), boundary.numpy(),
                                  np.ones(128, bool), int(star.gauge),
                                  device=dev)
    assert np.array_equal(star.valid.cpu().numpy(), wvalid)
    z = star.z.cpu().double().numpy()[wvalid]
    d = np.abs(z - wz[wvalid])
    d[:, 2] = np.abs((z[:, 2] - wz[wvalid][:, 2] + np.pi) % (2 * np.pi)
                     - np.pi)
    assert d.max() <= 5e-4
    om = G.unpack_info(star.info).cpu().double().numpy()[wvalid]
    rel = (np.linalg.norm(om - wom[wvalid], axis=(-2, -1))
           / np.linalg.norm(wom[wvalid], axis=(-2, -1)))
    assert rel.max() <= 1e-4
