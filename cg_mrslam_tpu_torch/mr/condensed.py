"""Condensed-graph construction: marginalize a robot's graph onto a
boundary vertex set as a star of labeled virtual edges.

Port of ``cg_mrslam_tpu/mr/condensed.py`` (the reference's
``CondensedGraphCreator`` + g2o ``EdgeLabeler``): with the robot's OWN edges
only, re-gauge at a gauge vertex, run one Gauss–Newton iteration, and label
each virtual edge gauge→vᵢ with the relative pose and the inverse of vᵢ's
marginal covariance conditioned on the gauge, moved into the edge's error
frame. The settle and the marginals go through the capacity-banded solver
(``solver/gauss_newton.py``): above ``DENSE_MAX`` the chain or PCG band,
under the (owner, keyframe) slot permutation.

Two gauge policies: the centroid (default) and the uncertainty-minimizing
:func:`select_gauge_optimal`, which condenses once per valid boundary
vertex in a host loop (the reference ``vmap``s the K condenses; invalid
slots can never win, so skipping them gives the same gauge).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.core.graph import (PoseGraph, add_edges_masked,
                                            fill, pack_info, remove_edges,
                                            row, unpack_info)
from cg_mrslam_tpu_torch.core.linearize import linearize
from cg_mrslam_tpu_torch.solver import gauss_newton as gn
from cg_mrslam_tpu_torch.utils import se2


class Star(NamedTuple):
    """Condensed graph: virtual edges gauge→boundary_k."""

    gauge: torch.Tensor      # [] int32 — gauge vertex index
    boundary: torch.Tensor   # [K] int32 — boundary vertex indices
    z: torch.Tensor          # [K, 3] — labeled measurements (gauge→vᵢ)
    info: torch.Tensor       # [K, 6] — packed information matrices
    valid: torch.Tensor      # [K] bool


def select_gauge_centroid(g: PoseGraph, boundary: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """The boundary vertex nearest the boundary centroid (reference
    ``selectGaugeCentroid``); ties to the first."""
    pos = g.poses[boundary.long(), :2]
    w = valid.to(pos.dtype)[:, None]
    centroid = torch.sum(pos * w, dim=0) / torch.clamp(torch.sum(w),
                                                       min=1.0)
    d = torch.linalg.norm(pos - centroid, dim=-1)
    d = torch.where(valid, d, torch.full_like(d, 1e9))
    return row(boundary, torch.argmin(d))


def select_gauge_optimal(g: PoseGraph, boundary: torch.Tensor,
                         valid: torch.Tensor, edge_mask: torch.Tensor,
                         order: torch.Tensor | None = None) -> torch.Tensor:
    """Uncertainty-minimizing gauge (reference ``selectOptimalGauge``):
    condense once per candidate gauge and pick the one whose star has the
    smallest total uncertainty Σₑ det(Ωₑ)⁻¹ (``computeOverallUncertainty``);
    the first minimum wins. The valid slots are read on the host (one
    read) and condensed one at a time; invalid slots score +inf."""
    u = torch.full(boundary.shape, float("inf"), dtype=g.poses.dtype,
                   device=g.poses.device)
    for k in torch.nonzero(valid.cpu()).reshape(-1).tolist():
        star = condense(g, boundary, valid, boundary[k], edge_mask, order)
        det = torch.linalg.det(unpack_info(star.info))
        inv = 1.0 / torch.clamp(det, min=1e-30)
        u[k] = torch.sum(torch.where(star.valid, inv,
                                     torch.zeros_like(inv)))
    return row(boundary, torch.argmin(u))


def condense(g: PoseGraph, boundary: torch.Tensor, valid: torch.Tensor,
             gauge: torch.Tensor, edge_mask: torch.Tensor,
             order: torch.Tensor | None = None) -> Star:
    """Build the labeled star (reference ``CondensedGraphCreator::compute``).
    ``edge_mask`` selects the edges marginalized over (callers pass the
    own-edges mask); ``boundary`` is padded to a static K with ``valid``;
    ``order`` is the chain permutation for the banded solver."""
    n = g.poses.shape[0]
    dev = g.poses.device
    # re-gauge: fix only the gauge vertex
    regauged = dataclasses.replace(
        g, fixed=torch.arange(n, device=dev) == gauge.long())
    # one GN settle on the selected edges
    regauged = gn.optimize_auto(regauged, 1, edge_mask, order=order)

    bl = boundary.long()
    z = se2.relative(row(regauged.poses, gauge), regauged.poses[bl])

    # boundary marginals conditioned on the gauge  [K,3,3]
    cov = gn.marginal_covariance_auto(regauged, boundary, edge_mask,
                                      order=order)

    # move covariance into the edge error frame (g2o EdgeLabeler's J·Σ·Jᵀ)
    e_ij = torch.stack([gauge.to(boundary.dtype).expand_as(boundary),
                        boundary], dim=-1)
    _, _, Jb = linearize(regauged.poses, e_ij, z)
    cov_e = Jb @ cov @ Jb.transpose(1, 2)
    # symmetrize + tiny jitter before inversion (near-rigid chains give
    # ill-conditioned covariances)
    cov_e = 0.5 * (cov_e + cov_e.transpose(-1, -2))
    cov_e = cov_e + 1e-9 * torch.eye(3, dtype=cov_e.dtype, device=dev)
    omega, _ = torch.linalg.inv_ex(cov_e)
    omega = 0.5 * (omega + omega.transpose(-1, -2))

    # the gauge's own slot (zero covariance) carries no edge
    ok = valid & (boundary != gauge)
    return Star(gauge=gauge, boundary=boundary, z=z, info=pack_info(omega),
                valid=ok)


def splice_star(g: PoseGraph, star: Star, owner) -> PoseGraph:
    """Replace-then-insert a peer's condensed star (reference
    ``insertEdgesFromRobot``): the previous star from the same robot,
    stored at level ``1 + owner``, is masked out first."""
    owner = (owner.to(torch.int32) if isinstance(owner, torch.Tensor)
             else fill(int(owner), g.e_owner))
    level = 1 + owner
    stale = g.emask & (g.e_owner == owner) & (g.e_level == level)
    g = remove_edges(g, stale)
    return add_edges_masked(
        g, star.gauge.to(star.boundary.dtype).expand_as(star.boundary),
        star.boundary, star.z, star.info, star.valid, level=level,
        owner=owner)
