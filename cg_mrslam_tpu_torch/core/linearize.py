"""Batched SE(2) edge linearization: errors, analytic Jacobians, chi2.

Port of ``cg_mrslam_tpu/core/linearize.py`` (g2o ``edge_se2.h``):
    error  e = z⁻¹ ∘ (xᵢ⁻¹ ∘ xⱼ)      (angle component wrapped to (-pi,pi])
    chi2     = Σ eᵀ Ω e  over active edges
with Jacobians in g2o's additive chart (``se2.oplus``).

Every function also takes a batch of graphs (poses ``[B, N, 3]``, edges
``[B, E, ...]``): the batch is flattened to one edge list over the
``[B·N]`` poses (:func:`flat_ends`), so each edge's numbers are those of
its graph alone.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cg_mrslam_tpu_torch.core.graph import PoseGraph, unpack_info
from cg_mrslam_tpu_torch.utils import se2


def flat_ends(poses: torch.Tensor, e_ij: torch.Tensor) -> torch.Tensor:
    """Edge endpoints ``[B, E, 2]`` as rows of the flattened ``[B·N, 3]``
    poses (graph ``b``'s vertices at rows ``b·N ..``)."""
    bl, n = poses.shape[:2]
    return e_ij.long() + n * torch.arange(bl, device=e_ij.device)[:, None,
                                                                  None]


def _batched(fn, poses, e_ij, e_z):
    """``fn`` over a batch, flattened to one edge list; each output
    ``[B·E, ...]`` back to ``[B, E, ...]``."""
    b, e = e_ij.shape[:2]
    out = fn(poses.reshape(-1, 3), flat_ends(poses, e_ij).reshape(-1, 2),
             e_z.reshape(-1, 3))
    if isinstance(out, tuple):
        return tuple(o.unflatten(0, (b, e)) for o in out)
    return out.unflatten(0, (b, e))


def edge_errors(poses: torch.Tensor, e_ij: torch.Tensor,
                e_z: torch.Tensor) -> torch.Tensor:
    """Errors ``[E, 3]`` for all edges given poses ``[N, 3]``."""
    if poses.dim() == 3:
        return _batched(edge_errors, poses, e_ij, e_z)
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
    if e.dim() == 3:
        return _quadratic(e.flatten(0, 1), unpack_info(
            g.e_info.flatten(0, 1))).unflatten(0, e.shape[:2])
    return _quadratic(e, unpack_info(g.e_info))


def linearize(poses: torch.Tensor, e_ij: torch.Tensor, e_z: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Errors + analytic Jacobians for every edge: ``(e [E,3], Ji [E,3,3],
    Jj [E,3,3])`` with ``Ji``/``Jj`` = ∂e/∂xᵢ, ∂e/∂xⱼ."""
    if poses.dim() == 3:
        return _batched(linearize, poses, e_ij, e_z)
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
