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
:func:`condense_optimal`, which condenses every valid boundary vertex as a
gauge in one batched :func:`condense` and keeps the winner's star from
that batch (the reference ``vmap``s the K condenses over every slot;
invalid slots can never win, so leaving them out gives the same gauge).

Spans and counters (``utils/metrics``, recorded while a profiler
records): ``star.optimal`` around an optimal star; ``condense.settle``,
``condense.marginals`` and ``condense.label`` inside every condense; the
counters ``condense.graphs`` (graph copies condensed), ``condense.columns``
(the marginals' 3K unit columns a copy, summed) and
``host_read.gauge_candidates`` (the optimal star's one host read).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.core.graph import (PoseGraph, add_edges_masked,
                                            fill, pack_info, remove_edges,
                                            row, unpack_info)
from cg_mrslam_tpu_torch.core.linearize import linearize
from cg_mrslam_tpu_torch.solver import gauss_newton as gn
from cg_mrslam_tpu_torch.utils import se2
from cg_mrslam_tpu_torch.utils.metrics import count, span

# The PCG band's CG budgets in a condense: the settle's GN×1 and the
# marginals' column solves (the solver's defaults are 96 and 160). At those
# defaults a star of robot 0's merged two-robot view at capacity 1024 lands
# as far from the exact float64 star as one computed in TF32 (uncertainty
# 0.8%, z 1e-3 m). At these the settle runs to its tolerance (376
# iterations there) and the marginals to ~1e-5 of the uncertainty. Both
# loops stop once every system has converged; other bands ignore them.
SETTLE_PCG_ITERS = 384
MARGINAL_PCG_ITERS = 384


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


def condense_optimal(g: PoseGraph, boundary: torch.Tensor,
                     valid: torch.Tensor, edge_mask: torch.Tensor,
                     order: torch.Tensor | None = None
                     ) -> tuple[Star, torch.Tensor]:
    """The star of the uncertainty-minimizing gauge (reference
    ``selectOptimalGauge``) and the total uncertainty ``[K]`` of every
    boundary slot as the gauge (``computeOverallUncertainty``: Σ det(Ωₑ)⁻¹
    over the valid edges of its star, +inf on an invalid slot). The valid
    slots are read on the host (one read) and condensed once each, as one
    batch of gauges; the first minimum wins and its star is taken from
    the batch. With no valid slot, the first slot is the gauge (the first
    minimum of an all-+inf row) and is condensed alone: its star carries
    no valid edge."""
    with span("star.optimal"):
        u = torch.full(boundary.shape, float("inf"), dtype=g.poses.dtype,
                       device=g.poses.device)
        count("host_read.gauge_candidates")
        idx = torch.nonzero(valid.cpu()).reshape(-1).to(boundary.device)
        if idx.numel() == 0:
            gauge = row(boundary, torch.argmin(u))
            return condense(g, boundary, valid, gauge, edge_mask, order), u
        stars = condense(g, boundary, valid, boundary[idx], edge_mask, order)
        det = torch.linalg.det(unpack_info(stars.info))         # [K',K]
        inv = 1.0 / torch.clamp(det, min=1e-30)
        uk = torch.sum(torch.where(stars.valid, inv, torch.zeros_like(inv)),
                       dim=-1)
        u[idx] = uk
        best = torch.argmin(uk)
        return Star(*(row(f, best) for f in stars)), u


def gauge_uncertainty(g: PoseGraph, boundary: torch.Tensor,
                      valid: torch.Tensor, edge_mask: torch.Tensor,
                      order: torch.Tensor | None = None) -> torch.Tensor:
    """The total uncertainty ``[K]`` of every boundary slot as the gauge
    (:func:`condense_optimal`'s second output)."""
    return condense_optimal(g, boundary, valid, edge_mask, order)[1]


def select_gauge_optimal(g: PoseGraph, boundary: torch.Tensor,
                         valid: torch.Tensor, edge_mask: torch.Tensor,
                         order: torch.Tensor | None = None) -> torch.Tensor:
    """Uncertainty-minimizing gauge (:func:`condense_optimal`'s star's
    gauge)."""
    return condense_optimal(g, boundary, valid, edge_mask, order)[0].gauge


def condense(g: PoseGraph, boundary: torch.Tensor, valid: torch.Tensor,
             gauge: torch.Tensor, edge_mask: torch.Tensor,
             order: torch.Tensor | None = None) -> Star:
    """Build the labeled star (reference ``CondensedGraphCreator::compute``).
    ``edge_mask`` selects the edges marginalized over (callers pass the
    own-edges mask); ``boundary`` is padded to a static K with ``valid``;
    ``order`` is the chain permutation for the banded solver. ``gauge``
    ``[G]`` condenses the graph once per gauge, as one batch of ``G``
    copies of the graph through the banded solver: a ``Star`` whose fields
    lead with ``[G]``."""
    n = g.poses.shape[0]
    dev = g.poses.device
    lead = gauge.shape
    if lead:
        g = PoseGraph(**{f.name: getattr(g, f.name).expand(
            lead + getattr(g, f.name).shape).contiguous()
            for f in dataclasses.fields(g)})
        edge_mask = edge_mask.expand(lead + edge_mask.shape)
    copies = math.prod(lead)
    count("condense.graphs", copies)
    count("condense.columns", 3 * boundary.shape[0] * copies)
    # re-gauge: fix only the gauge vertex
    gl = gauge.long()[..., None]
    regauged = dataclasses.replace(
        g, fixed=torch.arange(n, device=dev) == gl)
    # one GN settle on the selected edges. On the PCG band the settle's
    # and the marginals' CG stretches between the host's looks replay as
    # captured graphs: the settle's steps are too small to keep the card
    # busy (1.5 MB vectors at 128 copies), and a replay runs the
    # marginals' at the same addresses every star, with no launch waiting
    # on the host
    with span("condense.settle"):
        regauged = gn.optimize_auto(regauged, 1, edge_mask, order=order,
                                    pcg_iters=SETTLE_PCG_ITERS,
                                    pcg_graph=True)

    # boundary marginals conditioned on the gauge  [..., K,3,3]
    with span("condense.marginals"):
        cov = gn.marginal_covariance_auto(regauged, boundary, edge_mask,
                                          order=order,
                                          pcg_cg_iters=MARGINAL_PCG_ITERS,
                                          pcg_graph=True)

    with span("condense.label"):
        poses = regauged.poses
        at_gauge = torch.gather(poses, -2,
                                gl[..., None].expand(lead + (1, 3)))
        z = se2.relative(at_gauge, poses[..., boundary.long(), :])
        # move covariance into the edge error frame (g2o EdgeLabeler's
        # J·Σ·Jᵀ)
        bk = boundary.expand(lead + boundary.shape)
        e_ij = torch.stack([gauge.to(boundary.dtype)[..., None].expand_as(
            bk), bk], dim=-1)
        _, _, Jb = linearize(poses, e_ij, z)
        cov_e = Jb @ cov @ Jb.transpose(-1, -2)
        # symmetrize + tiny jitter before inversion (near-rigid chains
        # give ill-conditioned covariances)
        cov_e = 0.5 * (cov_e + cov_e.transpose(-1, -2))
        cov_e = cov_e + 1e-9 * torch.eye(3, dtype=cov_e.dtype, device=dev)
        omega, _ = torch.linalg.inv_ex(cov_e)
        omega = 0.5 * (omega + omega.transpose(-1, -2))

    # the gauge's own slot (zero covariance) carries no edge
    ok = valid & (boundary != gauge[..., None])
    return Star(gauge=gauge, boundary=bk, z=z, info=pack_info(omega),
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

