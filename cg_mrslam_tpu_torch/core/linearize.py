"""Batched SE(2) edge linearization: errors, analytic Jacobians, chi2.

Port of ``cg_mrslam_tpu/core/linearize.py`` (g2o ``edge_se2.h``):
    error  e = z⁻¹ ∘ (xᵢ⁻¹ ∘ xⱼ)      (angle component wrapped to (-pi,pi])
    chi2     = Σ eᵀ Ω e  over active edges
with Jacobians in g2o's additive chart (``se2.oplus``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from cg_mrslam_tpu_torch.core.graph import PoseGraph, unpack_info
from cg_mrslam_tpu_torch.utils import se2


def edge_errors(poses: torch.Tensor, e_ij: torch.Tensor,
                e_z: torch.Tensor) -> torch.Tensor:
    """Errors ``[E, 3]`` for all edges given poses ``[N, 3]``."""
    xi = poses[e_ij[:, 0].long()]
    xj = poses[e_ij[:, 1].long()]
    return se2.compose(se2.inverse(e_z), se2.relative(xi, xj))


def _quadratic(e: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ei,eij,ej->e", e, omega, e)


def chi2(g: PoseGraph, edge_mask: torch.Tensor | None = None
         ) -> torch.Tensor:
    """Total chi2 = Σ eᵀ Ω e over active edges (g2o ``activeChi2``)."""
    mask = g.emask if edge_mask is None else edge_mask
    per_edge = edge_chi2(g)
    return torch.sum(torch.where(mask, per_edge,
                                 torch.zeros_like(per_edge)), dim=-1)


def edge_chi2(g: PoseGraph) -> torch.Tensor:
    """Per-edge chi2 ``[E]`` (unmasked — caller applies masks)."""
    e = edge_errors(g.poses, g.e_ij, g.e_z)
    return _quadratic(e, unpack_info(g.e_info))


def linearize(poses: torch.Tensor, e_ij: torch.Tensor, e_z: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Errors + analytic Jacobians for every edge: ``(e [E,3], Ji [E,3,3],
    Jj [E,3,3])`` with ``Ji``/``Jj`` = ∂e/∂xᵢ, ∂e/∂xⱼ."""
    xi = poses[e_ij[:, 0].long()]
    xj = poses[e_ij[:, 1].long()]
    e = se2.compose(se2.inverse(e_z), se2.relative(xi, xj))

    ti, thi = xi[:, :2], xi[:, 2]
    tj = xj[:, :2]
    dz = e_z[:, 2]

    ci, si = torch.cos(thi), torch.sin(thi)
    cz, sz = torch.cos(dz), torch.sin(dz)

    # A = Rzᵀ Rᵢᵀ = R(-(θz+θi))
    cth = cz * ci - sz * si     # cos(θz+θi)
    sth = sz * ci + cz * si     # sin(θz+θi)

    # Rzᵀ (dRᵢᵀ/dθ) (tⱼ-tᵢ): dRᵀ/dθ = [[-s, c], [-c, -s]] at θᵢ, then Rzᵀ.
    d = tj - ti
    u = -si * d[:, 0] + ci * d[:, 1]
    v = -ci * d[:, 0] - si * d[:, 1]
    g0 = cz * u + sz * v
    g1 = -sz * u + cz * v

    zeros = torch.zeros_like(cth)
    ones = torch.ones_like(cth)
    Ji = torch.stack([
        torch.stack([-cth, -sth, g0], -1),
        torch.stack([sth, -cth, g1], -1),
        torch.stack([zeros, zeros, -ones], -1),
    ], dim=-2)
    Jj = torch.stack([
        torch.stack([cth, sth, zeros], -1),
        torch.stack([-sth, cth, zeros], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], dim=-2)
    return e, Ji, Jj
