"""Bounded graph distances + candidate grouping on the pose graph.

Port of ``cg_mrslam_tpu/pipeline/graph_dist.py`` (g2o ``HyperDijkstra`` as
used by the reference's ``VerticesFinder``): a fixed number of min-plus
relaxation sweeps instead of a heap, a near set (graph distance ≤ 2 m) and a
loop set (graph distance > 5 m, Euclidean ≤ 50 m), components by min-label
propagation and a closest-vertex representative per component. The
reference's ``lax.scan`` sweeps are Python loops of the same trip count;
``.at[].min`` scatters are ``scatter_reduce_(..., "amin")``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.core.graph import PoseGraph, fill, first_k, row

FAR = 1e9


def bounded_distances(g: PoseGraph, source: torch.Tensor,
                      sweeps: int = 32) -> torch.Tensor:
    """Graph distance ``[N]`` from ``source`` with Euclidean edge costs;
    distances that need more than ``sweeps`` relaxations stay at FAR."""
    n = g.poses.shape[0]
    dev = g.poses.device
    vi, vj = g.e_ij[:, 0].long(), g.e_ij[:, 1].long()
    w = torch.linalg.norm(g.poses[vi, :2] - g.poses[vj, :2], dim=-1)
    w = torch.where(g.emask, w, torch.full_like(w, FAR))
    src = torch.as_tensor(source, device=dev)
    dist = torch.where(torch.arange(n, device=dev) == src, 0.0, FAR)
    for _ in range(sweeps):
        di = dist[vi] + w
        dj = dist[vj] + w
        dist = dist.scatter_reduce(0, vj, di, "amin", include_self=True)
        dist = dist.scatter_reduce(0, vi, dj, "amin", include_self=True)
    return torch.where(g.vmask, dist, torch.full_like(dist, FAR))


class CandidateSets(NamedTuple):
    near: torch.Tensor  # [N] bool — scan-match candidates (graph dist ≤ sm)
    loop: torch.Tensor  # [N] bool — loop-closure candidates


def candidate_sets(g: PoseGraph, current: torch.Tensor, dist: torch.Tensor,
                   *, max_graph_dist_sm: float = 2.0,
                   min_graph_dist_lc: float = 5.0,
                   max_euc_dist_lc: float = 50.0) -> CandidateSets:
    """The reference's two candidate sets (``vertices_finder.cpp:35-79``)."""
    n = g.poses.shape[0]
    cur = torch.as_tensor(current, device=g.poses.device)
    euc = torch.linalg.norm(g.poses[:, :2] - row(g.poses, cur)[:2], dim=-1)
    live = g.vmask & (torch.arange(n, device=g.poses.device) != cur)
    near = live & (dist <= max_graph_dist_sm)
    loop = live & (dist > min_graph_dist_lc) & (euc <= max_euc_dist_lc)
    return CandidateSets(near=near, loop=loop)


def components(g: PoseGraph, member: torch.Tensor,
               sweeps: int = 32) -> torch.Tensor:
    """Component label ``[N]`` (int32) of the subgraph induced on
    ``member`` vertices: the min vertex index of the component, ``N`` for
    non-members."""
    n = g.poses.shape[0]
    dev = g.poses.device
    vi, vj = g.e_ij[:, 0].long(), g.e_ij[:, 1].long()
    ok = g.emask & member[vi] & member[vj]
    ar = torch.arange(n, device=dev)
    lab = torch.where(member, ar, torch.full_like(ar, n))
    none = torch.full_like(vi, n)
    for _ in range(sweeps):
        li = torch.where(ok, lab[vi], none)
        lj = torch.where(ok, lab[vj], none)
        m = torch.minimum(li, lj)
        lab = lab.scatter_reduce(0, vj, m, "amin", include_self=True)
        lab = lab.scatter_reduce(0, vi, m, "amin", include_self=True)
    return lab.to(torch.int32)


def expand_neighbors(member: torch.Tensor, v_owner: torch.Tensor,
                     v_remote: torch.Tensor, vmask: torch.Tensor, *,
                     n_robots: int, gap: int = 8) -> torch.Tensor:
    """Widen a candidate set by vertices within ±``gap`` keyframe ids of a
    member, per owner (reference ``addNeighboringVertices``): members mark
    a per-owner index line, a ±gap window sum dilates it, and every live
    vertex whose own cell is covered joins."""
    n = member.shape[0]
    dev = member.device
    stride = n + 2 * gap + 2
    total = n_robots * stride
    ok = vmask & (v_remote >= 0)
    key = (torch.clamp(v_owner.long(), 0, n_robots - 1) * stride
           + torch.clamp(v_remote.long(), 0, n - 1))
    hist = torch.zeros((total + 1,), dtype=torch.int32, device=dev)
    hist[torch.where(member & ok, key, torch.full_like(key, total))] = fill(
        1, hist)
    cs = torch.cumsum(hist[:total], 0)
    idx = torch.arange(total, device=dev)
    hi = cs[torch.clamp(idx + gap, 0, total - 1)]
    lo = torch.where(idx - gap - 1 >= 0,
                     cs[torch.clamp(idx - gap - 1, 0, total - 1)],
                     torch.zeros_like(cs))
    dilated = (hi - lo) > 0
    return member | (ok & dilated[key])


class Regions(NamedTuple):
    rep_vertex: torch.Tensor  # [K] int32 — closest member vertex per comp.
    valid: torch.Tensor       # [K] bool
    comp_label: torch.Tensor  # [K] int32 — the component's label


def pick_regions(g: PoseGraph, member: torch.Tensor, labels: torch.Tensor,
                 current: torch.Tensor, max_regions: int = 4) -> Regions:
    """Up to K components (lowest labels first), each represented by the
    member vertex closest (Euclidean) to the current vertex
    (``findClosestVertex``). Components beyond K are dropped."""
    n = g.poses.shape[0]
    dev = g.poses.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    is_rep = member & (labels == idx)
    score = torch.where(is_rep, -idx, torch.full_like(idx, -2 * n))
    _, reps = first_k(score, max_regions)             # ascending index
    valid = is_rep[reps]

    cur = torch.as_tensor(current, device=dev)
    euc = torch.linalg.norm(g.poses[:, :2] - row(g.poses, cur)[:2], dim=-1)
    in_comp = member[None, :] & (labels[None, :] == labels[reps][:, None])
    d = torch.where(in_comp, euc[None, :], torch.full_like(euc, FAR)[None])
    closest = torch.argmin(d, dim=1).to(torch.int32)  # first of equal
    return Regions(rep_vertex=torch.where(valid, closest,
                                          torch.zeros_like(closest)),
                   valid=valid, comp_label=labels[reps])
