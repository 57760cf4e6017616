"""Spanning-tree initial guess — g2o ``computeInitialGuess``.

Port of ``cg_mrslam_tpu/solver/initial_guess.py``. The reference runs
``initializeOptimization(edges)`` → ``computeInitialGuess()`` →
``optimize(1)`` before every sub-graph solve
(``graph_manipulator.cpp:116-124``): it REPLACES every free vertex estimate
by composing measurements along a minimum-hop spanning tree rooted at the
fixed (gauge) vertices.

Synchronous BFS relaxation: each sweep settles the next hop layer by two
int32 scatter-mins (the hop distance, then a deterministic winning edge
per vertex, coded ``2·edge + side``) and one gather of the parent pose
composed with the edge measurement. Integer minima are exact in any order,
so the card and the CPU build the same tree. ``sweeps`` is a static loop
with no host read; pass at least the tree depth (pose graphs are odometry
chains, so the live vertex count bounds it).
"""

from __future__ import annotations

import dataclasses

import torch

from cg_mrslam_tpu_torch.core.graph import PoseGraph
from cg_mrslam_tpu_torch.utils import se2

_BIG = 2 ** 30


def spanning_tree(g: PoseGraph, edge_mask: torch.Tensor | None = None,
                  sweeps: int = 64):
    """The tree relaxation behind :func:`spanning_tree_guess`: returns the
    hop distance of every vertex from the fixed ones (``2**30`` where not
    reached within ``sweeps``) and the propagated poses."""
    mask = g.emask if edge_mask is None else (g.emask & edge_mask)
    n = g.poses.shape[0]
    ecap = g.e_ij.shape[0]
    dev = g.poses.device
    vi, vj = g.e_ij[:, 0].long(), g.e_ij[:, 1].long()
    eidx = torch.arange(ecap, dtype=torch.int32, device=dev)
    big = torch.full((), _BIG, dtype=torch.int32, device=dev)

    dist = torch.where(g.fixed & g.vmask, torch.zeros_like(big), big)
    poses = g.poses
    for _ in range(sweeps):
        di, dj = dist[vi], dist[vj]
        # pass 1: settle the next distance layer
        newd = dist.scatter_reduce(
            0, vj, torch.where(mask & (di < _BIG), di + 1, big), "amin",
            include_self=True)
        newd = newd.scatter_reduce(
            0, vi, torch.where(mask & (dj < _BIG), dj + 1, big), "amin",
            include_self=True)
        # pass 2: deterministic winning edge per improved vertex (code =
        # 2·edge + direction, the lowest code wins: lowest edge index,
        # forward direction first)
        win_j = mask & (di + 1 == newd[vj]) & (newd[vj] < dist[vj])
        win_i = mask & (dj + 1 == newd[vi]) & (newd[vi] < dist[vi])
        code = torch.full((n,), _BIG, dtype=torch.int32,
                          device=dev).scatter_reduce(
            0, vj, torch.where(win_j, 2 * eidx, big), "amin",
            include_self=True)
        code = code.scatter_reduce(
            0, vi, torch.where(win_i, 2 * eidx + 1, big), "amin",
            include_self=True)
        improved = code < _BIG
        e_sel = torch.clamp(code // 2, 0, ecap - 1).long()
        fwd = se2.compose(poses[vi[e_sel]], g.e_z[e_sel])          # [N,3]
        bwd = se2.compose(poses[vj[e_sel]], se2.inverse(g.e_z[e_sel]))
        prop = torch.where((code % 2 == 0)[:, None], fwd, bwd)
        poses = torch.where(improved[:, None], prop, poses)
        dist = torch.where(improved, newd, dist)
    return dist, poses


def spanning_tree_guess(g: PoseGraph, edge_mask: torch.Tensor | None = None,
                        sweeps: int = 64) -> PoseGraph:
    """Re-initialize free vertices by composing measurements along a
    min-hop spanning tree from the fixed vertices. ``edge_mask`` restricts
    the propagation to an edge subset (``initializeOptimization(edgeSet)``);
    fixed vertices and vertices not reached within ``sweeps`` hops keep
    their estimates. Same-hop ties go to the lowest edge index, forward
    direction first."""
    return dataclasses.replace(g, poses=spanning_tree(g, edge_mask,
                                                      sweeps)[1])


def optimize_with_guess(g: PoseGraph, iterations: int = 1,
                        edge_mask: torch.Tensor | None = None,
                        sweeps: int = 64) -> PoseGraph:
    """The reference's ``GraphManipulator::optimize`` sequence: the
    spanning-tree initial guess, then ``iterations`` Gauss–Newton steps on
    the edge subset."""
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn

    g = spanning_tree_guess(g, edge_mask, sweeps=sweeps)
    return gn.optimize(g, iterations, edge_mask)
