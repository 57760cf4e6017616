"""Dense Gauss–Newton for SE(2) pose graphs: the batch-1 Cholesky band.

Port of the ``chol=True`` path of ``cg_mrslam_tpu/solver/gauss_newton.py``
(g2o ``SparseOptimizer`` + ``OptimizationAlgorithmGaussNewton``, driven by
``optimize(n)``, reference ``graph_slam.cpp:561-574``). The Hessian is a
dense ``[3N, 3N]`` matrix, factorized with Cholesky.

Two substitutions of TPU-only forms:

* assembly scatter-adds the per-edge 3×3 blocks with ``index_add_``
  instead of the reference's one-hot selection einsums (a workaround for
  serialized TPU scatters). The sums are the same; their order differs —
  on the card the scatter uses atomics, so results vary in the last bits
  from run to run;
* ``cho_factor``/``cho_solve`` become ``torch.linalg.cholesky_ex`` +
  ``torch.cholesky_solve``: no host sync, and a matrix that is not positive
  definite yields NaN as ``jax.scipy.linalg.cho_factor`` does, instead of
  raising.

The reference's ``chol`` switch is gone: this module is its ``chol=True``
path (the live, batch-1 one). Capacities above ``DENSE_MAX_CHOL`` belong to
the chain+Woodbury and PCG bands, which this package does not have yet: the
``*_auto`` entry points raise there rather than fall back to dense.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.core.graph import PoseGraph, unpack_info
from cg_mrslam_tpu_torch.core.linearize import linearize
from cg_mrslam_tpu_torch.utils import se2

# Capacity bands, copied unchanged from the reference (they decide which
# solver each keyframe bucket runs).
DENSE_MAX = 256
DENSE_MAX_CHOL = 512
PCG_MIN = 4096


class NormalEq(NamedTuple):
    H: torch.Tensor      # [3N, 3N]
    b: torch.Tensor      # [3N]  (gradient: Σ Jᵀ Ω e)
    free3: torch.Tensor  # [3N] float — 1.0 on free coordinates


def _free_mask(g: PoseGraph, edge_mask: torch.Tensor) -> torch.Tensor:
    """Free vertices: live, not gauge-fixed, and touched by at least one
    active edge (unconstrained vertices would make H singular, so they are
    pinned like fixed vertices)."""
    n = g.poses.shape[0]
    em = edge_mask.to(torch.int32)
    deg = torch.zeros((n,), dtype=torch.int32, device=g.poses.device)
    deg.index_add_(0, g.e_ij[:, 0].long(), em)
    deg.index_add_(0, g.e_ij[:, 1].long(), em)
    return g.vmask & ~g.fixed & (deg > 0)


def build_normal_equations(g: PoseGraph,
                           edge_mask: torch.Tensor | None = None
                           ) -> NormalEq:
    """Assemble H = Σ JᵀΩJ and b = Σ JᵀΩe over active edges by scattering
    the four 3×3 blocks of every edge into an ``[N, N, 3, 3]`` block
    array."""
    n = g.poses.shape[0]
    dt = g.poses.dtype
    emask_b = g.emask if edge_mask is None else edge_mask
    mask = emask_b.to(dt)

    e, Ji, Jj = linearize(g.poses, g.e_ij, g.e_z)
    omega = unpack_info(g.e_info) * mask[:, None, None]

    JiT_O = Ji.transpose(1, 2) @ omega      # Jᵢᵀ Ω  [E,3,3]
    JjT_O = Jj.transpose(1, 2) @ omega
    Hii = JiT_O @ Ji
    Hij = JiT_O @ Jj
    Hjj = JjT_O @ Jj
    bi = (JiT_O @ e[:, :, None])[:, :, 0]
    bj = (JjT_O @ e[:, :, None])[:, :, 0]

    vi, vj = g.e_ij[:, 0].long(), g.e_ij[:, 1].long()
    blocks = torch.zeros((n * n, 3, 3), dtype=dt, device=g.poses.device)
    blocks.index_add_(0, vi * n + vi, Hii)
    blocks.index_add_(0, vi * n + vj, Hij)
    blocks.index_add_(0, vj * n + vi, Hij.transpose(1, 2))
    blocks.index_add_(0, vj * n + vj, Hjj)
    H = blocks.reshape(n, n, 3, 3).permute(0, 2, 1, 3).reshape(3 * n, 3 * n)

    bv = torch.zeros((n, 3), dtype=dt, device=g.poses.device)
    bv.index_add_(0, vi, bi)
    bv.index_add_(0, vj, bj)

    free3 = torch.repeat_interleave(_free_mask(g, emask_b), 3).to(dt)
    return NormalEq(H=H, b=bv.reshape(3 * n), free3=free3)


def _gauge_fix(H: torch.Tensor, b: torch.Tensor, free3: torch.Tensor):
    """Project out fixed/unused coordinates; unit diagonal keeps H PD."""
    Hf = H * free3[:, None] * free3[None, :]
    Hf = Hf + torch.diag(1.0 - free3)
    return Hf, b * free3


def _cholesky(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN (not an exception, not a host sync) when
    ``H`` is not positive definite — ``cho_factor``'s behaviour."""
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def solve_normal_equations(eq: NormalEq) -> torch.Tensor:
    """dx = -H⁻¹ b by Cholesky (the reference's ``chol=True`` path; its
    batched SPD-inverse path waits for the chain band)."""
    H, b = _gauge_fix(eq.H, eq.b, eq.free3)
    dx = -torch.cholesky_solve(b[:, None], _cholesky(H))[:, 0]
    return dx * eq.free3


def gn_step(g: PoseGraph, edge_mask: torch.Tensor | None = None
            ) -> PoseGraph:
    """One linearize → solve → oplus update (g2o GN iteration)."""
    dx = solve_normal_equations(build_normal_equations(g, edge_mask))
    return dataclasses.replace(g, poses=se2.oplus(g.poses, dx.reshape(-1, 3)))


def optimize(g: PoseGraph, iterations: int = 5,
             edge_mask: torch.Tensor | None = None) -> PoseGraph:
    """``GraphSLAM::optimize(n)``: n Gauss–Newton iterations (the
    reference's ``lax.scan`` is a Python loop of the same trip count)."""
    for _ in range(iterations):
        g = gn_step(g, edge_mask)
    return g


def _check_band(n: int) -> None:
    if n > DENSE_MAX_CHOL:
        raise NotImplementedError(
            f"capacity {n} > DENSE_MAX_CHOL={DENSE_MAX_CHOL} needs the "
            "chain+Woodbury / PCG band (solver/chain.py, pcg.py), which "
            "is a later slice of the port")


def auto_backend(g: PoseGraph) -> torch.Tensor:
    """Which backend :func:`optimize_auto` takes: ``0`` dense (the only
    band ported)."""
    _check_band(g.poses.shape[-2])
    return torch.zeros((), dtype=torch.int32, device=g.poses.device)


def optimize_auto(g: PoseGraph, iterations: int = 5,
                  edge_mask: torch.Tensor | None = None) -> PoseGraph:
    """``optimize`` with the capacity-banded backend: dense Cholesky up to
    ``DENSE_MAX_CHOL``; raises above it (see module docstring)."""
    _check_band(g.poses.shape[-2])
    return optimize(g, iterations, edge_mask)


def marginal_covariance_auto(g: PoseGraph, query: torch.Tensor,
                             edge_mask: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """``marginal_covariance`` with the same banding as
    :func:`optimize_auto`."""
    _check_band(g.poses.shape[-2])
    return marginal_covariance(g, query, edge_mask)


def marginal_covariance(g: PoseGraph, query: torch.Tensor,
                        edge_mask: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Marginal 3×3 covariance blocks ``[Q, 3, 3]`` of the queried vertices
    ``query [Q]`` under the current linearization and gauge (g2o
    ``computeMarginals``): the queried columns of H⁻¹ from one Cholesky
    factorization."""
    eq = build_normal_equations(g, edge_mask)
    H, _ = _gauge_fix(eq.H, eq.b, eq.free3)
    # tiny jitter keeps H invertible for degenerate caller input
    n3 = H.shape[0]
    H = H + 1e-6 * torch.eye(n3, dtype=H.dtype, device=H.device)
    dev = H.device
    cols = (3 * query.long())[:, None] + torch.arange(3, device=dev)[None]
    L = _cholesky(H)
    q = query.shape[0]
    rhs = torch.zeros((n3, 3 * q), dtype=H.dtype, device=dev)
    rhs[cols.reshape(-1), torch.arange(3 * q, device=dev)] = torch.ones(
        (), dtype=H.dtype, device=dev)
    X = torch.cholesky_solve(rhs, L)                       # [3N, 3Q]
    Xq = X[cols.reshape(-1)].reshape(q, 3, q, 3)
    ar = torch.arange(q, device=dev)
    return Xq[ar, :, ar, :]                                # [Q,3,3]
